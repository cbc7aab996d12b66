"""Contract-drift checkers: code artifacts vs docs, both directions.

The reference system's headline defect was drift, not logic: the README
documented ``POST /api/v1/query`` while the server never registered it —
an endpoint that existed only on paper.  This module makes that class of
bug structurally impossible by parsing the *real* artifacts on both
sides and diffing them:

``route-contract``
    The monitor server's ``_ROUTES`` table + ``_dispatch`` prefix routes
    and the uav-agent's route dict + ``/api/v1/command/<cmd>`` prefix,
    against every route mentioned in README.md and docs/*.md.  Both
    directions: documented-but-unregistered AND registered-but-
    undocumented.  Paths are normalized (``{name}``/``<name>`` segments
    become a wildcard, ``{a,b,c}`` alternation expands, query strings
    drop); agent routes are recognized by their ``:9090`` prefix in
    docs.

``metrics-contract``
    Every gauge/counter/histogram family the exporter emits (literal
    ``w.metric("name", ...)``/``w.histogram("name", ...)`` calls, tuple-
    literal histogram tables, and manual ``w.lines.append(f"{_PREFIX}_
    ...")`` samples) against the machine-parseable inventory table in
    ``docs/observability.md`` — both directions — plus every
    ``k8s_llm_monitor_*`` token mentioned anywhere in the docs.  The JAX
    package's pass also holds the bench JSON keys cited in README.md and
    the Makefile to the keys ``bench.py`` emits; that part is left out
    here until the port has a bench of its own (``bench.py`` is the JAX
    package's).

``env-contract``
    Every literal ``os.environ``/``os.getenv`` read of a project-
    prefixed (``K8SLLM_*``/``OPENAI_*``) key must appear in the
    ``ENV_KEYS`` registry in ``monitor/config.py``; every registry entry
    must map to a real config dataclass field (``Class.field``,
    validated against the package AST) or an explicit runtime-toggle
    owner module that reads it; every registry key must be read
    somewhere and mentioned in the docs; and every ``K8SLLM_*`` token in
    the docs must be registered.  Keys derived generically by
    ``_apply_env`` (``fleet.role`` -> ``FLEET_ROLE``) are computed from
    the config dataclass tree and accepted as documented aliases.

What the docs and the copied config and exporter describe but the port
does not serve yet -- pieces of modules still to port (ROADMAP A8, A10)
-- is listed once, in :data:`DEFERRED`, with its ROADMAP label.  The
table is not a suppression: :func:`check_deferred` holds it equal to what
the port refuses (``monitor/server.py:_refuse_unported``) and to the
exporter families only a fleet router emits, both ways.

All checkers take source text (so tests can feed deliberately drifted
fixtures) and anchor findings at real file:line positions, honoring the
``# graftcheck: disable=RULE`` convention — though the policy for drift
findings is to reconcile, never suppress.  Run via
``graftcheck --contracts``.
"""

from __future__ import annotations

import ast
import dataclasses
import re
from pathlib import Path
from typing import Iterable

from .astlint import Finding, _suppressions, dotted_name

CONTRACT_RULE_NAMES = ("route-contract", "metrics-contract", "env-contract")

PACKAGE = "k8s_llm_monitor_tpu_torch"
METRIC_PREFIX = "k8s_llm_monitor"
ENV_PREFIXES = ("K8SLLM_", "OPENAI_")


# ---------------------------------------------------------------------------
# path normalization
# ---------------------------------------------------------------------------

def _norm_route(path: str) -> list[str]:
    """Normalize a documented/registered path; returns one or more
    normalized forms (brace alternation expands).  Param segments become
    ``*``; a trailing ``*`` marks a prefix route."""
    path = path.split("?")[0].rstrip(".,;:)")
    m = re.search(r"\{([^{}]*,[^{}]*)\}", path)
    if m:
        out: list[str] = []
        for alt in m.group(1).split(","):
            out.extend(_norm_route(path[:m.start()] + alt.strip()
                                   + path[m.end():]))
        return out
    segs = []
    for seg in path.split("/"):
        if (seg.startswith("{") and seg.endswith("}")) or \
                (seg.startswith("<") and seg.endswith(">")):
            segs.append("*")
        else:
            segs.append(seg)
    norm = "/".join(segs)
    return [norm if norm == "/" else norm.rstrip("/")
            or "/"] if norm else []


def _route_matches(doc: str, registered: set[str]) -> bool:
    if doc in registered:
        return True
    for reg in registered:
        if reg.endswith("/*") and (
                doc.startswith(reg[:-1]) or doc == reg[:-2]):
            return True
        if doc.endswith("/*") and (
                reg.startswith(doc[:-1]) or reg == doc[:-2]):
            return True
    return False


# ---------------------------------------------------------------------------
# registered routes (AST extraction)
# ---------------------------------------------------------------------------

def extract_server_routes(src: str) -> dict[tuple[str, str], int]:
    """(method, normalized path) -> line, from the monitor server's
    ``_ROUTES`` dict and the ``startswith`` prefix routes in
    ``_dispatch``.  A prefix route's method comes from its inline
    ``if method != "X": ...405...`` guard; GET when unguarded."""
    tree = ast.parse(src)
    out: dict[tuple[str, str], int] = {}
    for node in ast.walk(tree):
        is_routes = False
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict):
            is_routes = "_ROUTES" in {getattr(t, "id", "")
                                      for t in node.targets}
        elif isinstance(node, ast.AnnAssign) and isinstance(
                node.value, ast.Dict):
            is_routes = getattr(node.target, "id", "") == "_ROUTES"
        if is_routes:
            for key in node.value.keys:
                if isinstance(key, ast.Tuple) and len(key.elts) == 2 \
                        and all(isinstance(e, ast.Constant)
                                for e in key.elts):
                    method, path = (e.value for e in key.elts)
                    for norm in _norm_route(str(path)):
                        out[(str(method), norm)] = key.lineno
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                and node.name == "_dispatch":
            for sub in ast.walk(node):
                if not (isinstance(sub, ast.If)
                        and isinstance(sub.test, ast.Call)
                        and isinstance(sub.test.func, ast.Attribute)
                        and sub.test.func.attr == "startswith"
                        and sub.test.args
                        and isinstance(sub.test.args[0], ast.Constant)
                        and str(sub.test.args[0].value).startswith("/")):
                    continue
                prefix = str(sub.test.args[0].value).rstrip("/")
                method = "GET"
                for guard in sub.body:
                    if isinstance(guard, ast.If) \
                            and isinstance(guard.test, ast.Compare) \
                            and isinstance(guard.test.left, ast.Name) \
                            and guard.test.left.id == "method" \
                            and len(guard.test.ops) == 1 \
                            and isinstance(guard.test.ops[0], ast.NotEq) \
                            and isinstance(guard.test.comparators[0],
                                           ast.Constant):
                        method = str(guard.test.comparators[0].value)
                        break
                out[(method, f"{prefix}/*")] = sub.lineno
    return out


def extract_agent_routes(src: str) -> dict[tuple[str, str], int]:
    """(method, normalized path) -> line for the uav-agent: the route
    dict in ``do_GET`` plus each ``command == "x"`` branch under the
    ``/api/v1/command/`` POST prefix."""
    tree = ast.parse(src)
    out: dict[tuple[str, str], int] = {}
    post_prefix = ""
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            if node.name == "do_GET":
                for sub in ast.walk(node):
                    if isinstance(sub, ast.Dict) and sub.keys and all(
                            isinstance(k, ast.Constant)
                            and str(k.value).startswith("/")
                            for k in sub.keys):
                        for k in sub.keys:
                            for norm in _norm_route(str(k.value)):
                                out[("GET", norm)] = k.lineno
            elif node.name == "do_POST":
                for sub in ast.walk(node):
                    if isinstance(sub, ast.Call) \
                            and isinstance(sub.func, ast.Attribute) \
                            and sub.func.attr == "startswith" \
                            and sub.args \
                            and isinstance(sub.args[0], ast.Constant):
                        post_prefix = str(sub.args[0].value).rstrip("/")
                        out[("POST", f"{post_prefix}/*")] = sub.lineno
                for sub in ast.walk(node):
                    if isinstance(sub, ast.Compare) \
                            and isinstance(sub.left, ast.Name) \
                            and sub.left.id == "command" \
                            and len(sub.comparators) == 1 \
                            and isinstance(sub.comparators[0], ast.Constant) \
                            and post_prefix:
                        cmd = str(sub.comparators[0].value)
                        out[("POST", f"{post_prefix}/{cmd}")] = sub.lineno
    return out


# ---------------------------------------------------------------------------
# documented routes
# ---------------------------------------------------------------------------

_METHOD_PATH_RE = re.compile(
    r"\b(GET|POST|PUT|DELETE|PATCH)\s+(:\d+)?"
    r"(/[A-Za-z0-9_\-./{}<>,]*)")
_AGENT_PATH_RE = re.compile(
    r"(?:localhost)?:9090(/[A-Za-z0-9_\-./{}<>,]*)")
_BARE_PATH_RE = re.compile(
    r"`((?:GET|POST|PUT|DELETE|PATCH)?\s*/(?:api/v1|health|readyz|metrics"
    r"|debug)[A-Za-z0-9_\-./{}<>,]*)`")


@dataclasses.dataclass(frozen=True)
class DocRoute:
    server: str          # "monitor" | "agent"
    method: str | None   # None: bare path mention, method unknown
    path: str            # normalized
    file: str
    line: int


def extract_doc_routes(doc_texts: dict[str, str]) -> list[DocRoute]:
    out: list[DocRoute] = []
    seen: set[tuple[str, str | None, str]] = set()

    def add(server: str, method: str | None, raw: str,
            file: str, line: int) -> None:
        for norm in _norm_route(raw):
            if len(norm) < 2 or norm in ("/api", "/api/v1"):
                continue  # namespace mentions, not routes
            if "." in norm.rsplit("/", 1)[-1]:
                continue  # static asset (served by h_static catch-all)
            key = (server, method, norm)
            if key not in seen:
                seen.add(key)
                out.append(DocRoute(server, method, norm, file, line))

    for file, text in doc_texts.items():
        for lineno, linetext in enumerate(text.splitlines(), start=1):
            for m in _METHOD_PATH_RE.finditer(linetext):
                server = "agent" if m.group(2) == ":9090" else "monitor"
                add(server, m.group(1), m.group(3), file, lineno)
            for m in _AGENT_PATH_RE.finditer(linetext):
                before = linetext[:m.start()]
                xm = re.search(r"-X\s+(POST|PUT|DELETE|PATCH)\s*$|"
                               r"\b(GET|POST|PUT|DELETE|PATCH)\s+$", before)
                method = (xm.group(1) or xm.group(2)) if xm else "GET"
                add("agent", method, m.group(1), file, lineno)
            for m in _BARE_PATH_RE.finditer(linetext):
                token = m.group(1)
                vm = re.match(r"(GET|POST|PUT|DELETE|PATCH)\s+(/.*)", token)
                if vm:
                    add("monitor", vm.group(1), vm.group(2), file, lineno)
                else:
                    add("monitor", None, token, file, lineno)
    return out


def check_routes(server_src: str, agent_src: str,
                 doc_texts: dict[str, str],
                 server_path: str =
                 "k8s_llm_monitor_tpu_torch/monitor/server.py",
                 agent_path: str =
                 "k8s_llm_monitor_tpu_torch/monitor/agent.py"
                 ) -> list[Finding]:
    registered = {
        "monitor": (extract_server_routes(server_src), server_path),
        "agent": (extract_agent_routes(agent_src), agent_path),
    }
    doc_routes = extract_doc_routes(doc_texts)
    findings: list[Finding] = []
    # direction 1: documented but unregistered
    for dr in doc_routes:
        routes, _ = registered[dr.server]
        paths_any = {p for (_, p) in routes}
        if dr.method is None:
            ok = _route_matches(dr.path, paths_any)
        else:
            paths_m = {p for (mth, p) in routes if mth == dr.method}
            ok = _route_matches(dr.path, paths_m)
        if not ok:
            where = f"{dr.method} " if dr.method else ""
            findings.append(Finding(
                path=dr.file, line=dr.line, col=0, rule="route-contract",
                message=(f"documented route '{where}{dr.path}' "
                         f"({dr.server} server) is not registered — the "
                         f"reference's ghost-endpoint bug; register it or "
                         f"fix the doc")))
    # direction 2: registered but undocumented (path-level, method-lenient)
    doc_paths = {(dr.server, dr.path) for dr in doc_routes}
    for server, (routes, src_path) in registered.items():
        doc_for_server = {p for (s, p) in doc_paths if s == server}
        for (method, path), lineno in sorted(routes.items()):
            if not _route_matches(path, doc_for_server):
                findings.append(Finding(
                    path=src_path, line=lineno, col=0,
                    rule="route-contract",
                    message=(f"registered route '{method} {path}' "
                             f"({server} server) is not documented in "
                             f"README.md or docs/")))
    return findings


# ---------------------------------------------------------------------------
# metrics contract
# ---------------------------------------------------------------------------

def _collapse_family(name: str) -> str:
    for sfx in ("_bucket", "_sum", "_count"):
        if name.endswith(sfx):
            return name[: -len(sfx)]
    return name


def extract_exporter_metrics(src: str) -> dict[str, int]:
    """family name -> first-emission line, from ``w.metric``/
    ``w.histogram`` calls (literal or via a local tuple table of
    ``(name, help, hist)`` rows) and manual f-string sample lines."""
    tree = ast.parse(src)
    out: dict[str, int] = {}

    def note(name: str, line: int) -> None:
        if name and name not in out:
            out[name] = line

    for node in ast.walk(tree):
        if not isinstance(node, ast.Call) \
                or not isinstance(node.func, ast.Attribute):
            continue
        if node.func.attr in ("metric", "histogram") and node.args:
            first = node.args[0]
            if isinstance(first, ast.Constant) and isinstance(
                    first.value, str):
                note(first.value, node.lineno)  # already a family name
        elif node.func.attr == "append" and node.args and isinstance(
                node.args[0], ast.JoinedStr):
            # w.lines.append(f"{_PREFIX}_name_suffix ...") — a sample
            # line, so collapse _sum/_count/_bucket to the family
            parts = node.args[0].values
            if len(parts) >= 2 and isinstance(parts[0], ast.FormattedValue) \
                    and getattr(parts[0].value, "id", "") == "_PREFIX" \
                    and isinstance(parts[1], ast.Constant):
                text = str(parts[1].value)
                m = re.match(r"_([a-zA-Z0-9_]+)", text)
                if m:
                    note(_collapse_family(m.group(1)), node.lineno)
    # local tuple tables iterated into w.histogram(name, ...)
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and isinstance(
                node.value, (ast.Tuple, ast.List)):
            for elt in node.value.elts:
                if isinstance(elt, (ast.Tuple, ast.List)) and elt.elts \
                        and isinstance(elt.elts[0], ast.Constant) \
                        and isinstance(elt.elts[0].value, str) \
                        and re.fullmatch(r"[a-z][a-z0-9_]+",
                                         elt.elts[0].value):
                    note(elt.elts[0].value, elt.lineno)
    return out


_INVENTORY_ROW_RE = re.compile(
    rf"^\|\s*`?{METRIC_PREFIX}_([a-zA-Z0-9_]+)`?\s*\|")
_METRIC_MENTION_RE = re.compile(rf"\b{METRIC_PREFIX}_([a-zA-Z0-9_]+)")


def extract_doc_metric_inventory(obs_text: str) -> dict[str, int]:
    """Rows of the machine-parseable inventory table in
    docs/observability.md: metric family -> line."""
    out: dict[str, int] = {}
    for lineno, line in enumerate(obs_text.splitlines(), start=1):
        m = _INVENTORY_ROW_RE.match(line.strip())
        if m:
            out.setdefault(m.group(1), lineno)
    return out


def check_metrics(exporter_src: str, obs_text: str,
                  doc_texts: dict[str, str],
                  exporter_path: str =
                  "k8s_llm_monitor_tpu_torch/monitor/exporter.py",
                  obs_path: str = "docs/observability.md") -> list[Finding]:
    emitted = extract_exporter_metrics(exporter_src)
    inventory = extract_doc_metric_inventory(obs_text)
    findings: list[Finding] = []
    # exporter -> inventory
    for fam, line in sorted(emitted.items()):
        if fam not in inventory:
            findings.append(Finding(
                path=exporter_path, line=line, col=0,
                rule="metrics-contract",
                message=(f"exporter emits '{METRIC_PREFIX}_{fam}' but the "
                         f"inventory table in {obs_path} does not list "
                         f"it")))
    # inventory -> exporter
    for fam, line in sorted(inventory.items()):
        if fam not in emitted:
            findings.append(Finding(
                path=obs_path, line=line, col=0, rule="metrics-contract",
                message=(f"inventory lists '{METRIC_PREFIX}_{fam}' but "
                         f"the exporter never emits it")))
    # every prefixed mention anywhere in the docs must be a real family
    for file, text in doc_texts.items():
        for lineno, line in enumerate(text.splitlines(), start=1):
            for m in _METRIC_MENTION_RE.finditer(line):
                tok = m.group(1)
                if tok == "tpu" or tok.startswith(("tpu_", "tpu.")):
                    continue  # the package is named k8s_llm_monitor_tpu
                fam = _collapse_family(tok).rstrip("_")
                if tok.rstrip("_") not in emitted and fam not in emitted:
                    findings.append(Finding(
                        path=file, line=lineno, col=0,
                        rule="metrics-contract",
                        message=(f"doc mentions metric "
                                 f"'{METRIC_PREFIX}_{m.group(1)}' which "
                                 f"the exporter never emits")))
    return findings


# ---------------------------------------------------------------------------
# env contract
# ---------------------------------------------------------------------------

def _module_str_constants(tree: ast.Module) -> dict[str, str]:
    out: dict[str, str] = {}
    for node in tree.body:
        if isinstance(node, ast.Assign) and isinstance(node.value,
                                                       ast.Constant) \
                and isinstance(node.value.value, str):
            for t in node.targets:
                if isinstance(t, ast.Name):
                    out[t.id] = node.value.value
    return out


def extract_env_reads(py_sources: dict[str, str]
                      ) -> dict[str, list[tuple[str, int]]]:
    """Literal project-prefixed env reads across the package:
    key -> [(file, line)].  Resolves module-level string constants used
    as the key (``os.environ.get(ENV_FLAG)``)."""
    out: dict[str, list[tuple[str, int]]] = {}

    def note(key: str, file: str, line: int) -> None:
        if any(key.startswith(p) for p in ENV_PREFIXES):
            out.setdefault(key, []).append((file, line))

    for file, src in py_sources.items():
        try:
            tree = ast.parse(src)
        except SyntaxError:
            continue
        consts = _module_str_constants(tree)

        def resolve(node: ast.AST) -> str:
            if isinstance(node, ast.Constant) and isinstance(node.value,
                                                             str):
                return node.value
            if isinstance(node, ast.Name):
                return consts.get(node.id, "")
            return ""

        for node in ast.walk(tree):
            if isinstance(node, ast.Call):
                dn = dotted_name(node.func)
                if dn in ("os.environ.get", "os.getenv",
                          "os.environ.setdefault", "os.environ.pop") \
                        and node.args:
                    key = resolve(node.args[0])
                    if key:
                        note(key, file, node.lineno)
            elif isinstance(node, ast.Subscript) and dotted_name(
                    node.value) == "os.environ":
                key = resolve(node.slice)
                if key:
                    note(key, file, node.lineno)
            elif isinstance(node, ast.Compare) and len(
                    node.comparators) == 1 and dotted_name(
                    node.comparators[0]) == "os.environ":
                key = resolve(node.left)
                if key:
                    note(key, file, node.lineno)
    return out


def extract_env_registry(config_src: str) -> dict[str, tuple[str, int]]:
    """``ENV_KEYS`` dict literal in monitor/config.py:
    key -> (target, line)."""
    tree = ast.parse(config_src)
    out: dict[str, tuple[str, int]] = {}
    for node in ast.walk(tree):
        value = None
        if isinstance(node, ast.Assign):
            names = {getattr(t, "id", "") for t in node.targets}
            value = node.value if "ENV_KEYS" in names else None
        elif isinstance(node, ast.AnnAssign):
            if getattr(node.target, "id", "") == "ENV_KEYS":
                value = node.value
        if isinstance(value, ast.Dict):
            for k, v in zip(value.keys, value.values):
                if isinstance(k, ast.Constant) and isinstance(
                        v, ast.Constant):
                    out[str(k.value)] = (str(v.value), k.lineno)
    return out


def extract_dataclass_fields(py_sources: dict[str, str]) -> set[str]:
    """All ``Class.field`` pairs from annotated class bodies across the
    package (lint-grade: any annotated class attribute counts)."""
    out: set[str] = set()
    for src in py_sources.values():
        try:
            tree = ast.parse(src)
        except SyntaxError:
            continue
        for node in ast.walk(tree):
            if not isinstance(node, ast.ClassDef):
                continue
            for stmt in node.body:
                if isinstance(stmt, ast.AnnAssign) and isinstance(
                        stmt.target, ast.Name):
                    out.add(f"{node.name}.{stmt.target.id}")
    return out


def derived_env_keys(config_src: str) -> set[str]:
    """Env keys ``_apply_env`` derives from the config dataclass tree:
    dotted path ``fleet.role`` -> ``FLEET_ROLE``, rooted at ``Config``."""
    tree = ast.parse(config_src)
    classes: dict[str, list[tuple[str, str]]] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.ClassDef):
            fields = []
            for stmt in node.body:
                if isinstance(stmt, ast.AnnAssign) and isinstance(
                        stmt.target, ast.Name):
                    ann = stmt.annotation
                    ann_name = ann.value if isinstance(
                        ann, ast.Constant) else getattr(ann, "id", "")
                    fields.append((stmt.target.id, str(ann_name)))
            classes[node.name] = fields
    out: set[str] = set()

    def walk(cls: str, prefix: str, depth: int = 0) -> None:
        if depth > 6:
            return
        for fname, ann in classes.get(cls, []):
            if ann in classes:
                walk(ann, prefix + fname + "_", depth + 1)
            else:
                out.add((prefix + fname).upper())

    walk("Config", "")
    return out


_ENV_MENTION_RE = re.compile(r"\b(K8SLLM_[A-Z0-9_]+|OPENAI_[A-Z0-9_]+)\b")


def check_env(py_sources: dict[str, str], config_src: str,
              doc_texts: dict[str, str],
              config_path: str =
              "k8s_llm_monitor_tpu_torch/monitor/config.py"
              ) -> list[Finding]:
    reads = extract_env_reads(py_sources)
    registry = extract_env_registry(config_src)
    fields = extract_dataclass_fields(py_sources)
    derived = derived_env_keys(config_src)
    doc_mentions: dict[str, tuple[str, int]] = {}
    for file, text in doc_texts.items():
        for lineno, line in enumerate(text.splitlines(), start=1):
            for m in _ENV_MENTION_RE.finditer(line):
                doc_mentions.setdefault(m.group(1), (file, lineno))
    findings: list[Finding] = []
    # 1. every read key is registered
    for key, sites in sorted(reads.items()):
        if key not in registry:
            file, line = sites[0]
            findings.append(Finding(
                path=file, line=line, col=0, rule="env-contract",
                message=(f"env read of '{key}' is not declared in "
                         f"ENV_KEYS ({config_path}); register it with "
                         f"its config field or runtime owner")))
    for key, (target, line) in sorted(registry.items()):
        # 2. registry target is a real config field or a runtime owner
        if target.startswith("runtime:"):
            owner = target.split(":", 1)[1]
            owner_files = [f for f in py_sources
                           if f.replace("\\", "/").endswith(owner)]
            if not owner_files or not any(
                    f in {s[0] for s in reads.get(key, [])}
                    for f in owner_files):
                findings.append(Finding(
                    path=config_path, line=line, col=0,
                    rule="env-contract",
                    message=(f"ENV_KEYS declares '{key}' as a runtime "
                             f"toggle owned by {owner}, but that module "
                             f"never reads it")))
        elif target not in fields:
            findings.append(Finding(
                path=config_path, line=line, col=0, rule="env-contract",
                message=(f"ENV_KEYS maps '{key}' to '{target}' which is "
                         f"not a dataclass field anywhere in the "
                         f"package")))
        # 3. every registered key is actually read somewhere
        if key not in reads:
            findings.append(Finding(
                path=config_path, line=line, col=0, rule="env-contract",
                message=(f"ENV_KEYS declares '{key}' but no module reads "
                         f"it — dead configuration surface")))
        # 4. every registered key has a doc mention
        if key not in doc_mentions:
            findings.append(Finding(
                path=config_path, line=line, col=0, rule="env-contract",
                message=(f"env key '{key}' is undocumented — mention it "
                         f"in README.md or docs/")))
    # 5. every doc-mentioned project key is registered or derivable
    for key, (file, line) in sorted(doc_mentions.items()):
        if key in registry or key in derived:
            continue
        findings.append(Finding(
            path=file, line=line, col=0, rule="env-contract",
            message=(f"doc mentions env key '{key}' which is neither in "
                     f"ENV_KEYS nor derivable from the config tree")))
    return findings


# ---------------------------------------------------------------------------
# what the port does not serve yet
# ---------------------------------------------------------------------------

#: Contract surface of modules the port has not ported yet: (rule, items,
#: ROADMAP label, how the port refuses or lacks them).  Documented in
#: README.md / docs and present in the copied config and exporter, so the
#: three checkers above see no drift; :func:`check_deferred` holds this
#: table equal to the code.  Training (A11) has no route, family or env
#: key on this surface.
DEFERRED: tuple[tuple[str, tuple[str, ...], str, str], ...] = (
    ("env-contract", ("ANALYSIS_EMBEDDING_MODEL",), "A10",
     "build_server raises NotImplementedError for analysis.embedding_model "
     "(the embedding anomaly detector)"),
    ("env-contract", ("FLEET_ROLE",), "A8",
     "build_server and cmd.server raise NotImplementedError for "
     "fleet.role 'router' (the fleet router)"),
    ("metrics-contract", (
        "fleet_affinity_hits_total", "fleet_affinity_spills_total",
        "fleet_drain_sweeps_total", "fleet_failovers_total",
        "fleet_handoffs_total", "fleet_hedge_delay_seconds",
        "fleet_hedges_fired_total", "fleet_hedges_won_total",
        "fleet_prefix_migrations_total", "fleet_replica_dispatches_total",
        "fleet_replica_draining", "fleet_replica_failures_total",
        "fleet_replica_inflight", "fleet_replica_prefix_hit_rate",
        "fleet_replica_ready", "fleet_replica_role", "fleet_scrape_age_s",
        "fleet_sheds_total"), "A8",
     "emitted by exporter._fleet_metrics, only on a fleet router"),
    ("metrics-contract", ("autoscale_actions_total",
                          "autoscale_breaker_open"), "A8",
     "emitted by exporter._autoscaler_metrics, only on a fleet router "
     "with autoscale.enabled"),
)

#: The exporter functions that run only on a fleet router (A8).
ROUTER_ONLY_EXPORTERS = ("_fleet_metrics", "_autoscaler_metrics")


def refused_config_keys(server_src: str) -> dict[str, int]:
    """Env names of the config fields ``_refuse_unported`` refuses
    (``config.fleet.role`` -> ``FLEET_ROLE``) -> line."""
    out: dict[str, int] = {}
    for node in ast.walk(ast.parse(server_src)):
        if not (isinstance(node, ast.FunctionDef)
                and node.name == "_refuse_unported"):
            continue
        for sub in ast.walk(node):
            if isinstance(sub, ast.If):
                for leaf in ast.walk(sub.test):
                    dn = dotted_name(leaf)
                    parts = dn.split(".")
                    if len(parts) == 3 and parts[0] == "config":
                        out.setdefault("_".join(parts[1:]).upper(),
                                       sub.lineno)
    return out


def router_only_families(exporter_src: str) -> dict[str, int]:
    """Families emitted inside :data:`ROUTER_ONLY_EXPORTERS` -> line."""
    out: dict[str, int] = {}
    for node in ast.parse(exporter_src).body:
        if isinstance(node, ast.FunctionDef) \
                and node.name in ROUTER_ONLY_EXPORTERS:
            seg = ast.Module(body=[node], type_ignores=[])
            for fam, line in extract_exporter_metrics(
                    ast.unparse(seg)).items():
                out.setdefault(fam, node.lineno)
    return out


def check_deferred(server_src: str, exporter_src: str,
                   server_path: str =
                   "k8s_llm_monitor_tpu_torch/monitor/server.py",
                   exporter_path: str =
                   "k8s_llm_monitor_tpu_torch/monitor/exporter.py",
                   table=DEFERRED) -> list[Finding]:
    """:data:`DEFERRED` against the code, both directions: every refused
    config key and router-only family is listed, and every listed item is
    refused or router-only."""
    listed = {rule: {i for r, items, _, _ in table if r == rule
                     for i in items}
              for rule in ("env-contract", "metrics-contract")}
    actual = {"env-contract": (refused_config_keys(server_src),
                               server_path),
              "metrics-contract": (router_only_families(exporter_src),
                                   exporter_path)}
    this = "k8s_llm_monitor_tpu_torch/devtools/contracts.py"
    findings: list[Finding] = []
    for rule, (found, path) in actual.items():
        for item, line in sorted(found.items()):
            if item not in listed[rule]:
                findings.append(Finding(
                    path=path, line=line, col=0, rule=rule,
                    message=(f"the port does not serve '{item}' but "
                             f"DEFERRED ({this}) does not list it with "
                             f"its ROADMAP label")))
        for item in sorted(listed[rule] - set(found)):
            findings.append(Finding(
                path=this, line=1, col=0, rule=rule,
                message=(f"DEFERRED lists '{item}' but the port neither "
                         f"refuses it nor leaves it to a fleet router: "
                         f"take it out of the table")))
    return findings


# ---------------------------------------------------------------------------
# driver
# ---------------------------------------------------------------------------

def _doc_texts(repo_root: Path) -> dict[str, str]:
    out: dict[str, str] = {}
    for p in [repo_root / "README.md", repo_root / "Makefile",
              *sorted((repo_root / "docs").glob("*.md"))]:
        if p.is_file():
            out[str(p.relative_to(repo_root))] = p.read_text(
                encoding="utf-8")
    return out


def run_contracts(repo_root: Path,
                  rules: Iterable[str] | None = None,
                  deferred=DEFERRED) -> list[Finding]:
    repo_root = Path(repo_root)
    wanted = set(rules) if rules is not None else set(CONTRACT_RULE_NAMES)
    pkg = repo_root / PACKAGE
    docs = _doc_texts(repo_root)

    def rel(p: Path) -> str:
        return str(p.relative_to(repo_root))

    py_sources = {rel(p): p.read_text(encoding="utf-8")
                  for p in sorted(pkg.rglob("*.py"))
                  if "__pycache__" not in p.parts}
    findings: list[Finding] = []
    if "route-contract" in wanted:
        findings.extend(check_routes(
            py_sources[f"{PACKAGE}/monitor/server.py"],
            py_sources[f"{PACKAGE}/monitor/agent.py"],
            {f: t for f, t in docs.items() if f.endswith(".md")}))
    if "metrics-contract" in wanted:
        obs = docs.get("docs/observability.md", "")
        findings.extend(check_metrics(
            py_sources[f"{PACKAGE}/monitor/exporter.py"], obs, docs))
    if "env-contract" in wanted:
        findings.extend(check_env(
            py_sources, py_sources[f"{PACKAGE}/monitor/config.py"],
            {f: t for f, t in docs.items() if f.endswith(".md")}))
    findings.extend(f for f in check_deferred(
        py_sources[f"{PACKAGE}/monitor/server.py"],
        py_sources[f"{PACKAGE}/monitor/exporter.py"], table=deferred)
        if f.rule in wanted)
    # suppressions on the anchoring line (policy: reconcile, don't
    # suppress — but the mechanism stays uniform across graftcheck)
    out: list[Finding] = []
    cache: dict[str, tuple[dict[int, set[str]], set[str]]] = {}
    for f in findings:
        if f.path not in cache:
            src = py_sources.get(f.path)
            if src is None:
                src = docs.get(f.path, "")
            cache[f.path] = _suppressions(src)
        per_line, per_file = cache[f.path]
        if f.rule in per_file or "all" in per_file:
            continue
        line_rules = per_line.get(f.line, set())
        if f.rule in line_rules or "all" in line_rules:
            continue
        out.append(f)
    out.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    return out


def render(findings: list[Finding]) -> str:
    if not findings:
        return "graftcheck contracts: clean"
    lines = [f.human() for f in findings]
    lines.append(f"graftcheck contracts: {len(findings)} finding(s)")
    return "\n".join(lines)
