"""Whole-program dataflow lint: call graph + interprocedural rules.

The per-node rules in :mod:`astlint` cannot see that ``time.sleep`` is
*reachable from* the decode hot loop three calls away, or that a helper
called from inside a CUDA graph's capture does a host read, or that two
modules acquire the same pair of locks in opposite orders.  This module
builds a package-wide call graph over the AST (no imports executed), runs
a small reaching-defs/taint walk inside each function, and powers three
interprocedural rules on top:

``blocking-in-hot-path``
    time.sleep / socket / urllib / file IO / subprocess / a pipe's
    ``recv`` or ``send`` reachable via the call graph from the serving hot
    entry points (engine ``step()``, prefill/decode dispatch, the service
    loop, the mesh's replay of a device call).  Structural exclusions, in
    order of precedence:

    * the enclosing function is *watchdog-guarded* — its body references
      the dispatch watchdog (``watchdog_trips`` / ``dispatch_timeout_s``):
      blocking there is the bounded wait the watchdog exists to supervise;
    * the blocking call carries an explicit ``timeout=`` keyword (bounded
      by construction);
    * a ``time.sleep`` whose duration taints back to the fault injector
      (``*.delay_s(...)``) — chaos hooks are dormant in production;
    * the call site is in a *sanctioned* (module, function, reason) entry
      of :data:`SANCTIONED_BLOCKING` — e.g. the WAL append in
      ``resilience/journal.py``, where the blocking write *is* the
      durability contract, or the mesh's pipe to its workers, where rank
      0 must hand every device call over before it runs its share.

``capture-hazard``
    Host reads (``time.*`` / ``os.getenv`` / ``random.*``) and
    device->host syncs (``.item()`` / ``.tolist()`` / ``.cpu()`` /
    ``.numpy()`` / ``synchronize``) inside functions that *flow into* a
    CUDA graph's capture via the call graph — the static complement of
    traceguard's replays under ``torch.cuda.set_sync_debug_mode("error")``,
    covering all code rather than the traced paths.  The roots are
    astlint's :func:`~.astlint.graph_bodies` (``_DecodeProgram._run`` and
    ``_SpecProgram._run``).  Direct host reads inside a root are astlint's
    ``graph-host-read``; this rule reports the interprocedural cases plus
    syncs anywhere, and one hazard astlint cannot see: an attribute of the
    programs' owner that a root reads (``eng.pages``) and that a method of
    the owner rebinds without dropping the captured programs (the
    counterpart of a mutable closure capture handed to ``jax.jit``: every
    replay keeps the old tensor).  The call graph does not follow a
    function passed as a value (``attn_impl=``) or held in an attribute
    (``eng._decode_step``): the attention wrappers are held to it at run
    time, on the card.

``lock-order-static``
    Cross-module lock-acquisition orderings that form a cycle — the
    static twin of lockcheck's runtime DFS.  Lock identity comes from
    ``make_lock("name")`` assignment sites, so ``self._lock`` in two
    different classes never unifies; edges come from lexically nested
    ``with`` blocks *and* from calls made while a lock is held, resolved
    through the call graph with a transitive may-acquire fixpoint.

Suppression uses the established ``# graftcheck: disable=RULE`` comment
on the line of the *anchoring site* (the sleep, the host read, the inner
acquisition).  Unit-tested on fixture packages in
tests/test_torch_dataflow.py; run via ``graftcheck --dataflow``.
"""

from __future__ import annotations

import ast
import dataclasses
from pathlib import Path
from typing import Iterable, Iterator

from .astlint import (Finding, _suppressions, device_sync, dotted_name,
                      graph_bodies, host_read, iter_py_files)

DATAFLOW_RULE_NAMES = ("blocking-in-hot-path", "capture-hazard",
                       "lock-order-static")

PACKAGE = "k8s_llm_monitor_tpu_torch"

#: Hot-path roots: (path suffix, qualified function name).  Everything
#: transitively reachable from these is "hot" for blocking-in-hot-path.
HOT_ENTRIES: tuple[tuple[str, str], ...] = (
    ("serving/engine.py", "InferenceEngine.step"),
    ("serving/engine.py", "InferenceEngine._dispatch_prefill_chunks"),
    ("serving/engine.py", "InferenceEngine._dispatch_decode"),
    ("serving/service.py", "EngineService._run"),
    ("parallel/mesh.py", "Mesh.replay"),
)

#: (path suffix, function or "" for the whole module, reason) entries
#: where blocking calls are the contract.  Kept deliberately short; every
#: entry must say *why* in one clause.
SANCTIONED_BLOCKING: tuple[tuple[str, str, str], ...] = (
    ("resilience/journal.py", "",
     "WAL durability: the fsync'd append IS the contract"),
    ("observability/flight.py", "",
     "crash-edge flight dump: runs once, on the way down"),
    ("parallel/mesh.py", "Mesh.send",
     "rank 0 must hand every device call to the workers before it runs "
     "its share: the pipe send is the replay contract"),
    ("parallel/mesh.py", "Mesh.check",
     "reads a worker's message only after poll() says one is waiting"),
)

#: Method names too generic to resolve by name alone — linking every
#: ``x.get(...)`` to every ``def get`` in the package would drown the
#: graph in false edges.
_FALLBACK_STOPLIST = frozenset({
    "get", "put", "pop", "items", "keys", "values", "append", "extend",
    "add", "update", "clear", "copy", "remove", "discard", "sort",
    "index", "count", "read", "write", "close", "flush", "seek", "tell",
    "encode", "decode", "split", "strip", "join", "format", "lower",
    "upper", "startswith", "endswith", "group", "match", "search", "sub",
    "findall", "acquire", "release", "notify", "notify_all", "wait",
    "set", "is_set", "isoformat", "timestamp", "result", "done", "name",
    "cancel", "send", "recv", "keys", "exists", "mkdir", "touch",
    # torch.cuda.Event / Stream / CUDAGraph methods
    "query", "record", "synchronize", "replay", "wait_stream",
    "wait_event",
})
_FALLBACK_MAX_CANDIDATES = 6

_WATCHDOG_MARKERS = ("watchdog_trips", "watchdog", "dispatch_timeout_s")
_FAULT_RECEIVER_HINTS = ("fault", "injector", "inj")


# ---------------------------------------------------------------------------
# package index
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class FuncInfo:
    qname: str                 # "<dotted module>::Class.method" / "::func"
    module: str                # dotted module name
    cls: str | None
    name: str                  # bare function name
    qual: str                  # "Class.method" or "func" (or "outer.<locals>.f")
    node: ast.FunctionDef | ast.AsyncFunctionDef
    path: str

    @property
    def display(self) -> str:
        return f"{self.module.rsplit('.', 1)[-1]}.{self.qual}"


@dataclasses.dataclass
class ModuleInfo:
    module: str                          # dotted name
    path: str
    tree: ast.Module
    src: str
    functions: dict[str, FuncInfo]       # qual -> FuncInfo
    imports: dict[str, str]              # local alias -> dotted target
    classes: dict[str, ast.ClassDef]
    bases: dict[str, list[str]]          # class -> base local names


class PackageIndex:
    """All modules + functions of the scanned tree, with import maps."""

    def __init__(self) -> None:
        self.modules: dict[str, ModuleInfo] = {}
        self.funcs: dict[str, FuncInfo] = {}          # qname -> info
        self.methods: dict[str, list[FuncInfo]] = {}  # method name -> infos
        self.node_to_func: dict[int, FuncInfo] = {}   # id(ast node) -> info
        # attribute -> (module, dotted name) of each function an
        # ``self.<attribute> = <function>`` assignment binds to it
        # (``self._decode_step = overlap_decode_step if ... else
        # llama.decode_step``), so a call through the attribute resolves.
        self.attr_refs: dict[str, list[tuple[str, str]]] = {}

    # -- construction -------------------------------------------------

    @staticmethod
    def _dotted_module(path: Path) -> str:
        parts = list(path.with_suffix("").parts)
        if PACKAGE in parts:
            parts = parts[parts.index(PACKAGE):]
        else:
            parts = parts[-1:]
        if parts and parts[-1] == "__init__":
            parts = parts[:-1] or parts
        return ".".join(parts)

    def add_module(self, path: Path, src: str) -> None:
        try:
            tree = ast.parse(src)
        except SyntaxError:
            return  # astlint reports parse errors; skip here
        module = self._dotted_module(path)
        imports: dict[str, str] = {}
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                for alias in node.names:
                    imports[alias.asname or alias.name.split(".")[0]] = \
                        alias.name if alias.asname else alias.name.split(".")[0]
            elif isinstance(node, ast.ImportFrom):
                base = node.module or ""
                if node.level:  # relative: resolve against this module
                    pkg = module.split(".")
                    pkg = pkg[:len(pkg) - node.level]
                    base = ".".join(pkg + ([base] if base else []))
                for alias in node.names:
                    imports[alias.asname or alias.name] = f"{base}.{alias.name}"
        classes = {n.name: n for n in tree.body
                   if isinstance(n, ast.ClassDef)}
        bases = {cname: [dotted_name(b).rsplit(".", 1)[-1]
                         for b in cnode.bases if dotted_name(b)]
                 for cname, cnode in classes.items()}
        info = ModuleInfo(module=module, path=str(path), tree=tree, src=src,
                          functions={}, imports=imports, classes=classes,
                          bases=bases)
        self.modules[module] = info
        self._register_functions(info)
        for node in ast.walk(tree):
            if not (isinstance(node, ast.Assign) and len(node.targets) == 1
                    and isinstance(node.targets[0], ast.Attribute)
                    and dotted_name(node.targets[0].value) == "self"):
                continue
            value, refs = node.value, []
            stack = [value]
            while stack:
                v = stack.pop()
                if isinstance(v, ast.IfExp):
                    stack += [v.body, v.orelse]
                elif dotted_name(v) and not dotted_name(v).startswith(
                        "self."):
                    refs.append(dotted_name(v))
                else:
                    refs = []
                    break
            for ref in refs:
                self.attr_refs.setdefault(node.targets[0].attr, []).append(
                    (module, ref))

    def _register_functions(self, mi: ModuleInfo) -> None:
        def register(node, cls: str | None, prefix: str) -> None:
            qual = f"{prefix}{node.name}"
            fi = FuncInfo(qname=f"{mi.module}::{qual}", module=mi.module,
                          cls=cls, name=node.name, qual=qual,
                          node=node, path=mi.path)
            mi.functions[qual] = fi
            self.funcs[fi.qname] = fi
            self.node_to_func[id(node)] = fi
            if cls is not None:
                self.methods.setdefault(node.name, []).append(fi)
            for sub in node.body:
                walk(sub, cls, f"{qual}.<locals>.")

        def walk(node, cls: str | None, prefix: str) -> None:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                register(node, cls, prefix)
            elif isinstance(node, ast.ClassDef):
                for sub in node.body:
                    walk(sub, node.name, f"{prefix}{node.name}.")
            elif isinstance(node, (ast.If, ast.Try, ast.With, ast.For,
                                   ast.While)):
                for sub in ast.iter_child_nodes(node):
                    walk(sub, cls, prefix)

        for top in mi.tree.body:
            walk(top, None, "")

    # -- method resolution helpers ------------------------------------

    def _class_method(self, mi: ModuleInfo, cls: str,
                      meth: str) -> FuncInfo | None:
        """Look up a method on a class, following base-class names through
        the index (by bare name — a lint-grade MRO)."""
        seen: set[str] = set()
        queue = [(mi, cls)]
        while queue:
            m, c = queue.pop(0)
            if (m.module, c) in seen:
                continue
            seen.add((m.module, c))
            fi = m.functions.get(f"{c}.{meth}")
            if fi is not None:
                return fi
            for base in m.bases.get(c, []):
                for m2 in self.modules.values():
                    if base in m2.classes:
                        queue.append((m2, base))
        return None

    def resolve_call(self, call: ast.Call, fi: FuncInfo) -> list[FuncInfo]:
        """Best-effort static resolution of a call site to FuncInfos."""
        dn = dotted_name(call.func)
        if not dn:
            return []
        mi = self.modules[fi.module]
        parts = dn.split(".")
        # self.method(...) — own class first, then name fallback.
        if parts[0] == "self" and fi.cls and len(parts) == 2:
            hit = self._class_method(mi, fi.cls, parts[1])
            if hit is not None:
                return [hit]
            return self._attr_funcs(parts[1]) or \
                self._by_method_name(parts[1])
        if parts[0] in ("self", "cls") and len(parts) > 2:
            return self._by_method_name(parts[-1])
        if len(parts) == 1:
            name = parts[0]
            # sibling nested def in the same enclosing function
            if "<locals>" in fi.qual:
                outer = fi.qual.rsplit(".<locals>.", 1)[0]
                sib = mi.functions.get(f"{outer}.<locals>.{name}")
                if sib is not None:
                    return [sib]
            # nested def of this function
            nested = mi.functions.get(f"{fi.qual}.<locals>.{name}")
            if nested is not None:
                return [nested]
            if name in mi.functions:
                return [mi.functions[name]]
            if name in mi.classes:
                init = mi.functions.get(f"{name}.__init__")
                return [init] if init is not None else []
            target = mi.imports.get(name, "")
            return self._from_import(target)
        # module-qualified: alias.func(...) where alias maps to a module
        head = mi.imports.get(parts[0], "")
        if head:
            hit = self._from_import(".".join([head] + parts[1:]))
            if hit:
                return hit
        return self._attr_funcs(parts[-1]) or self._by_method_name(parts[-1])

    def _attr_funcs(self, attr: str) -> list[FuncInfo]:
        """The functions bound to ``self.<attr>`` anywhere in the index."""
        out: list[FuncInfo] = []
        for module, ref in self.attr_refs.get(attr, []):
            mi = self.modules[module]
            head, _, rest = ref.partition(".")
            if not rest and head in mi.functions:
                out.append(mi.functions[head])
            else:
                target = mi.imports.get(head, "")
                out += self._from_import(
                    ".".join([target] + ([rest] if rest else [])))
        return out

    def _from_import(self, target: str) -> list[FuncInfo]:
        """Resolve a dotted target like pkg.mod.func or pkg.mod.Class."""
        if not target:
            return []
        mod, _, leaf = target.rpartition(".")
        mi = self.modules.get(mod)
        if mi is None:
            return []
        if leaf in mi.functions:
            return [mi.functions[leaf]]
        if leaf in mi.classes:
            init = mi.functions.get(f"{leaf}.__init__")
            return [init] if init is not None else []
        # re-export through __init__: follow one import hop
        fwd = mi.imports.get(leaf, "")
        if fwd and fwd != target:
            return self._from_import(fwd)
        return []

    def _by_method_name(self, meth: str) -> list[FuncInfo]:
        if meth in _FALLBACK_STOPLIST:
            return []
        cands = self.methods.get(meth, [])
        if not cands or len(cands) > _FALLBACK_MAX_CANDIDATES:
            return []
        return list(cands)


def build_index(paths: Iterable[Path]) -> PackageIndex:
    idx = PackageIndex()
    for root in paths:
        for p in iter_py_files(Path(root)):
            idx.add_module(p, p.read_text(encoding="utf-8"))
    return idx


# ---------------------------------------------------------------------------
# call graph + reachability
# ---------------------------------------------------------------------------

def _own_body(fi: FuncInfo) -> Iterator[ast.AST]:
    """Walk a function body, not descending into nested defs/lambdas
    (those are separate graph nodes, reached only if called)."""
    stack: list[ast.AST] = list(fi.node.body)
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            continue
        yield node
        stack.extend(ast.iter_child_nodes(node))


def call_edges(idx: PackageIndex,
               fi: FuncInfo) -> list[tuple[ast.Call, FuncInfo]]:
    out: list[tuple[ast.Call, FuncInfo]] = []
    for node in _own_body(fi):
        if isinstance(node, ast.Call):
            for callee in idx.resolve_call(node, fi):
                out.append((node, callee))
    return out


def reachable_from(idx: PackageIndex, roots: list[FuncInfo]
                   ) -> dict[str, tuple[str | None, int]]:
    """BFS over the call graph.  Returns {qname: (caller qname, call line)}
    with roots mapped to (None, 0) — enough to rebuild a witness chain."""
    pred: dict[str, tuple[str | None, int]] = {r.qname: (None, 0)
                                               for r in roots}
    queue = list(roots)
    while queue:
        fi = queue.pop(0)
        for call, callee in call_edges(idx, fi):
            if callee.qname in pred:
                continue
            pred[callee.qname] = (fi.qname, call.lineno)
            queue.append(callee)
    return pred


def witness_chain(idx: PackageIndex, pred: dict[str, tuple[str | None, int]],
                  qname: str, limit: int = 6) -> str:
    chain: list[str] = []
    cur: str | None = qname
    while cur is not None and len(chain) < limit:
        fi = idx.funcs.get(cur)
        chain.append(fi.display if fi else cur)
        cur = pred.get(cur, (None, 0))[0]
    return " <- ".join(chain)


# ---------------------------------------------------------------------------
# intraprocedural reaching defs (single-assignment approximation)
# ---------------------------------------------------------------------------

def reaching_defs(fi: FuncInfo) -> dict[str, ast.AST]:
    defs: dict[str, ast.AST] = {}
    for node in _own_body(fi):
        if isinstance(node, ast.Assign):
            for tgt in node.targets:
                if isinstance(tgt, ast.Name):
                    defs[tgt.id] = node.value
        elif isinstance(node, ast.AnnAssign) and node.value is not None:
            if isinstance(node.target, ast.Name):
                defs[node.target.id] = node.value
    return defs


def _expr_taints_fault_delay(expr: ast.AST,
                             defs: dict[str, ast.AST],
                             depth: int = 0) -> bool:
    """True if the expression (transitively through local names) contains
    a fault-injector delay read — ``*.delay_s(...)`` or a call on a
    receiver whose name hints at the injector."""
    if depth > 4:
        return False
    for node in ast.walk(expr) if not isinstance(expr, ast.Name) else [expr]:
        if isinstance(node, ast.Name):
            bound = defs.get(node.id)
            if bound is not None and bound is not expr \
                    and _expr_taints_fault_delay(bound, defs, depth + 1):
                return True
        elif isinstance(node, ast.Call):
            dn = dotted_name(node.func)
            if dn.endswith(".delay_s"):
                return True
            recv = dn.rsplit(".", 2)
            if len(recv) >= 2 and any(h in recv[-2].lower()
                                      for h in _FAULT_RECEIVER_HINTS):
                return True
    return False


# ---------------------------------------------------------------------------
# rule: blocking-in-hot-path
# ---------------------------------------------------------------------------

_BLOCKING_CALLS = {
    "time.sleep": "sleep",
    "socket.create_connection": "socket",
    "socket.getaddrinfo": "socket",
    "urllib.request.urlopen": "HTTP",
    "urlopen": "HTTP",
    "subprocess.run": "subprocess", "subprocess.Popen": "subprocess",
    "subprocess.check_output": "subprocess",
    "subprocess.check_call": "subprocess", "subprocess.call": "subprocess",
    "os.system": "subprocess",
}
_BLOCKING_METHOD_SUFFIXES = {
    "read_text": "file IO", "write_text": "file IO",
    "read_bytes": "file IO", "write_bytes": "file IO",
    "recv": "pipe", "recv_bytes": "pipe",
}
_PIPE_SENDS = ("send", "send_bytes")
_PIPE_HINTS = ("conn", "pipe")
_REQUESTS_VERBS = {"get", "post", "put", "delete", "head", "patch",
                   "request"}


def _classify_blocking(call: ast.Call) -> str:
    dn = dotted_name(call.func)
    if dn in _BLOCKING_CALLS:
        return f"{dn} ({_BLOCKING_CALLS[dn]})"
    parts = dn.split(".")
    if dn == "open" or (parts[-1] == "open" and len(parts) >= 2
                        and parts[-2] in ("io", "gzip", "Path")):
        return f"{dn} (file IO)"
    if len(parts) >= 2 and parts[-2] == "requests" \
            and parts[-1] in _REQUESTS_VERBS:
        return f"{dn} (HTTP)"
    if parts[-1] in _BLOCKING_METHOD_SUFFIXES:
        return f"{dn} ({_BLOCKING_METHOD_SUFFIXES[parts[-1]]})"
    if parts[-1] == "join" and len(parts) >= 2 \
            and "thread" in parts[-2].lower():
        return f"{dn} (thread join)"
    if parts[-1] in _PIPE_SENDS and len(parts) >= 2 \
            and any(h in parts[-2].lower() for h in _PIPE_HINTS):
        return f"{dn} (pipe)"
    return ""


def _has_timeout_kwarg(call: ast.Call) -> bool:
    return any(kw.arg == "timeout" for kw in call.keywords)


def _is_watchdog_guarded(fi: FuncInfo) -> bool:
    for node in ast.walk(fi.node):
        if isinstance(node, ast.Attribute) \
                and node.attr in _WATCHDOG_MARKERS:
            return True
        if isinstance(node, ast.Name) and node.id in _WATCHDOG_MARKERS:
            return True
    return False


def _sanction_reason(fi: FuncInfo) -> str:
    norm = fi.path.replace("\\", "/")
    for suffix, qual, reason in SANCTIONED_BLOCKING:
        if norm.endswith(suffix) and qual in ("", fi.qual):
            return reason
    return ""


def check_blocking_in_hot_path(
        idx: PackageIndex,
        entries: Iterable[tuple[str, str]] = HOT_ENTRIES) -> list[Finding]:
    roots = [fi for fi in idx.funcs.values()
             for (sfx, qual) in entries
             if fi.qual == qual and fi.path.replace("\\", "/").endswith(sfx)]
    pred = reachable_from(idx, roots)
    findings: list[Finding] = []
    for qname in pred:
        fi = idx.funcs[qname]
        if _is_watchdog_guarded(fi):
            continue
        if _sanction_reason(fi):
            continue
        defs = reaching_defs(fi)
        for node in _own_body(fi):
            if not isinstance(node, ast.Call):
                continue
            label = _classify_blocking(node)
            if not label:
                continue
            if _has_timeout_kwarg(node):
                continue
            if label.startswith("time.sleep") and node.args \
                    and _expr_taints_fault_delay(node.args[0], defs):
                continue
            findings.append(Finding(
                path=fi.path, line=node.lineno, col=node.col_offset,
                rule="blocking-in-hot-path",
                message=(f"blocking call '{label}' reachable from a "
                         f"serving hot entry: "
                         f"{witness_chain(idx, pred, qname)}; move it off "
                         f"the step/dispatch path or bound it with the "
                         f"watchdog")))
    return findings


# ---------------------------------------------------------------------------
# rule: capture-hazard
# ---------------------------------------------------------------------------

def _graph_roots(idx: PackageIndex) -> list[FuncInfo]:
    roots: list[FuncInfo] = []
    for mi in idx.modules.values():
        for body in graph_bodies(mi.tree):
            fi = idx.node_to_func.get(id(body))
            if fi is not None:
                roots.append(fi)
    return roots


def _host_read_findings(fi: FuncInfo, is_root: bool,
                        chain: str) -> Iterator[Finding]:
    for node in _own_body(fi):
        if not isinstance(node, ast.Call):
            continue
        hazard = ""
        dn = device_sync(node)
        if dn:
            hazard = (f"'{dn}()' syncs the device with the host in a "
                      f"function a CUDA graph captures (the capture fails, "
                      f"or every replay reuses the value read once)")
        elif not is_root:
            # depth>=1 only: direct reads in the root are astlint's
            # graph-host-read; this rule adds the interprocedural cases.
            dn = host_read(node)
            if dn:
                hazard = (f"'{dn}()' reads host state in a function a CUDA "
                          f"graph captures (frozen into every replay)")
        if hazard:
            yield Finding(
                path=fi.path, line=node.lineno, col=node.col_offset,
                rule="capture-hazard",
                message=f"{hazard}; captured via: {chain}")


def _self_attr(node: ast.AST) -> str:
    """``x`` for ``self.x``, else ""."""
    if isinstance(node, ast.Attribute) and isinstance(node.value, ast.Name) \
            and node.value.id == "self":
        return node.attr
    return ""


def _owner_reads(fi: FuncInfo) -> tuple[str, set[str]]:
    """(attribute of the root's object that refers to its owner, the owner
    attributes the root reads through it): ``eng = self.eng`` then
    ``eng.pages`` reads ``pages`` of the owner held in ``self.eng``."""
    aliases: dict[str, str] = {}
    for node in _own_body(fi):
        if isinstance(node, ast.Assign) and _self_attr(node.value):
            for tgt in node.targets:
                if isinstance(tgt, ast.Name):
                    aliases[tgt.id] = _self_attr(node.value)
    reads: dict[str, set[str]] = {}
    for node in _own_body(fi):
        if not (isinstance(node, ast.Attribute)
                and isinstance(node.ctx, ast.Load)):
            continue
        base = node.value
        ref = ""
        if isinstance(base, ast.Name) and base.id in aliases:
            ref = aliases[base.id]
        elif _self_attr(base):
            ref = _self_attr(base)
        if ref:
            reads.setdefault(ref, set()).add(node.attr)
    if not reads:
        return "", set()
    ref = max(reads, key=lambda r: len(reads[r]))
    return ref, reads[ref]


def _stale_inputs(idx: PackageIndex, roots: list[FuncInfo]
                  ) -> Iterator[Finding]:
    """The counterpart of a mutable capture handed to ``jax.jit``: a root
    reads its owner's Python state (``eng.pages``, ``eng._fsm_trans``),
    whose tensors the capture freezes by address; a method of the owner
    that rebinds one of those attributes after construction, without
    dropping the captured programs in the same method, leaves every
    replay on the old tensor.  The owner is the class that constructs the
    root's class passing ``self``; its programs live in the attribute the
    construction is stored into (``self._programs[key] = ...``)."""
    root_classes: dict[str, set[str]] = {}    # class -> owner attrs read
    for fi in roots:
        if fi.cls is None:
            continue
        _, attrs = _owner_reads(fi)
        root_classes.setdefault(fi.cls, set()).update(attrs)
    if not root_classes:
        return
    for mi in idx.modules.values():
        for owner in mi.classes:
            store: set[str] = set()
            reads: set[str] = set()
            for fi in mi.functions.values():
                if fi.cls != owner:
                    continue
                for node in _own_body(fi):
                    if not isinstance(node, ast.Assign):
                        continue
                    built = {dotted_name(c.func).rsplit(".", 1)[-1]
                             for c in ast.walk(node.value)
                             if isinstance(c, ast.Call) and any(
                                 isinstance(a, ast.Name) and a.id == "self"
                                 for a in c.args)}
                    hits = built & set(root_classes)
                    if not hits:
                        continue
                    for h in hits:
                        reads |= root_classes[h]
                    for tgt in node.targets:
                        if isinstance(tgt, ast.Subscript) \
                                and _self_attr(tgt.value):
                            store.add(_self_attr(tgt.value))
            if not store:
                continue
            for fi in mi.functions.values():
                if fi.cls != owner or fi.name == "__init__":
                    continue
                drops = False
                rebinds: list[tuple[ast.AST, str]] = []
                for node in _own_body(fi):
                    if isinstance(node, (ast.Assign, ast.AugAssign,
                                         ast.AnnAssign)):
                        tgts = node.targets if isinstance(node, ast.Assign) \
                            else [node.target]
                        for tgt in tgts:
                            attr = _self_attr(tgt)
                            if attr in store:
                                drops = True
                            elif attr in reads:
                                rebinds.append((node, attr))
                    elif isinstance(node, ast.Call) \
                            and isinstance(node.func, ast.Attribute) \
                            and node.func.attr in ("clear", "pop") \
                            and _self_attr(node.func.value) in store:
                        drops = True
                if drops:
                    continue
                for node, attr in rebinds:
                    yield Finding(
                        path=fi.path, line=node.lineno, col=node.col_offset,
                        rule="capture-hazard",
                        message=(f"{owner}.{fi.qual.rsplit('.', 1)[-1]} "
                                 f"rebinds '{attr}', which a captured "
                                 f"program reads, without dropping the "
                                 f"programs in '{sorted(store)[0]}': every "
                                 f"replay keeps the old tensor; copy into "
                                 f"the buffer in place, or drop the "
                                 f"programs here"))


def check_capture_hazard(idx: PackageIndex) -> list[Finding]:
    roots = _graph_roots(idx)
    pred = reachable_from(idx, roots)
    findings: list[Finding] = []
    for qname in pred:
        fi = idx.funcs[qname]
        is_root = pred[qname][0] is None
        chain = witness_chain(idx, pred, qname)
        findings.extend(_host_read_findings(fi, is_root, chain))
    findings.extend(_stale_inputs(idx, roots))
    return findings


# ---------------------------------------------------------------------------
# rule: lock-order-static
# ---------------------------------------------------------------------------

def _lock_identities(idx: PackageIndex) -> dict[tuple[str, str], str]:
    """Map (scope, attr/var) -> lock name from make_lock("name") sites.
    Scope is the class name for ``self.x = make_lock(...)`` and the
    module for module-level ``x = make_lock(...)``."""
    out: dict[tuple[str, str], str] = {}
    for mi in idx.modules.values():
        for node in ast.walk(mi.tree):
            if not (isinstance(node, ast.Assign)
                    and isinstance(node.value, ast.Call)):
                continue
            dn = dotted_name(node.value.func)
            if dn.rsplit(".", 1)[-1] != "make_lock":
                continue
            if not (node.value.args
                    and isinstance(node.value.args[0], ast.Constant)):
                continue
            name = str(node.value.args[0].value)
            for tgt in node.targets:
                tdn = dotted_name(tgt)
                if tdn.startswith("self."):
                    # find enclosing class by scanning registered funcs
                    for fi in mi.functions.values():
                        if fi.cls and fi.node.lineno <= node.lineno \
                                <= (fi.node.end_lineno or fi.node.lineno):
                            out[(fi.cls, tdn[5:])] = name
                            break
                elif isinstance(tgt, ast.Name):
                    out[(mi.module, tgt.id)] = name
    return out


def _resolve_lock(expr: ast.AST, fi: FuncInfo,
                  idents: dict[tuple[str, str], str]) -> str | None:
    dn = dotted_name(expr)
    if not dn:
        return None
    if dn.startswith("self.") and fi.cls:
        attr = dn[5:]
        if (fi.cls, attr) in idents:
            return idents[(fi.cls, attr)]
        leaf = attr.rsplit(".", 1)[-1].lower()
        if any(k in leaf for k in ("lock", "mutex", "cond")):
            return f"{fi.cls}.{attr}"        # class-scoped identity
        return None
    if (fi.module, dn) in idents:
        return idents[(fi.module, dn)]
    leaf = dn.rsplit(".", 1)[-1].lower()
    if any(k in leaf for k in ("lock", "mutex", "cond")):
        return f"{fi.module}:{dn}"           # module-scoped identity
    return None


def _direct_acquires(idx: PackageIndex, idents: dict[tuple[str, str], str]
                     ) -> dict[str, list[tuple[str, ast.With]]]:
    out: dict[str, list[tuple[str, ast.With]]] = {}
    for fi in idx.funcs.values():
        acqs: list[tuple[str, ast.With]] = []
        for node in _own_body(fi):
            if isinstance(node, (ast.With, ast.AsyncWith)):
                for item in node.items:
                    lock = _resolve_lock(item.context_expr, fi, idents)
                    if lock is not None:
                        acqs.append((lock, node))
        out[fi.qname] = acqs
    return out


def _may_acquire(idx: PackageIndex,
                 direct: dict[str, list[tuple[str, ast.With]]]
                 ) -> dict[str, set[str]]:
    """Transitive lock-acquisition sets: fixpoint over the call graph."""
    edges: dict[str, set[str]] = {}
    for fi in idx.funcs.values():
        edges[fi.qname] = {c.qname for _, c in call_edges(idx, fi)}
    acq: dict[str, set[str]] = {q: {l for l, _ in direct.get(q, [])}
                                for q in idx.funcs}
    changed = True
    rounds = 0
    while changed and rounds < 50:
        changed = False
        rounds += 1
        for q, callees in edges.items():
            before = len(acq[q])
            for c in callees:
                acq[q] |= acq.get(c, set())
            if len(acq[q]) != before:
                changed = True
    return acq


def check_lock_order_static(idx: PackageIndex) -> list[Finding]:
    idents = _lock_identities(idx)
    direct = _direct_acquires(idx, idents)
    trans = _may_acquire(idx, direct)
    # order edges: (outer, inner) -> anchoring site
    sites: dict[tuple[str, str], tuple[str, int, str]] = {}

    def note(outer: str, inner: str, path: str, line: int,
             how: str) -> None:
        if outer != inner and (outer, inner) not in sites:
            sites[(outer, inner)] = (path, line, how)

    for fi in idx.funcs.values():
        def walk(node: ast.AST, held: tuple[str, ...]) -> None:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.Lambda)):
                return
            new_held = held
            if isinstance(node, (ast.With, ast.AsyncWith)):
                for item in node.items:
                    lock = _resolve_lock(item.context_expr, fi, idents)
                    if lock is not None:
                        for h in new_held:
                            note(h, lock, fi.path, node.lineno,
                                 "nested with")
                        new_held = new_held + (lock,)
                for sub in node.body:
                    walk(sub, new_held)
                return
            if isinstance(node, ast.Call) and held:
                for _, callee in ((node, c)
                                  for c in idx.resolve_call(node, fi)):
                    for lock in trans.get(callee.qname, set()):
                        for h in held:
                            note(h, lock, fi.path, node.lineno,
                                 f"call into {callee.display}")
            for sub in ast.iter_child_nodes(node):
                walk(sub, held)

        for stmt in fi.node.body:
            walk(stmt, ())

    # cycle detection over the order graph
    graph: dict[str, set[str]] = {}
    for (a, b) in sites:
        graph.setdefault(a, set()).add(b)
    findings: list[Finding] = []
    seen_cycles: set[tuple[str, ...]] = set()

    def dfs(start: str, cur: str, path: list[str]) -> None:
        for nxt in sorted(graph.get(cur, ())):
            if nxt == start and len(path) > 1:
                lo = path.index(min(path))
                canon = tuple(path[lo:] + path[:lo])
                if canon in seen_cycles:
                    continue
                seen_cycles.add(canon)
                edge = sites[(path[-1], start)]
                order = " -> ".join(path + [start])
                findings.append(Finding(
                    path=edge[0], line=edge[1], col=0,
                    rule="lock-order-static",
                    message=(f"lock acquisition order cycle {order} "
                             f"(closing edge via {edge[2]}); acquire in "
                             f"one global order or drop to a snapshot")))
            elif nxt not in path:
                dfs(start, nxt, path + [nxt])

    for n in sorted(graph):
        dfs(n, n, [n])
    return findings


# ---------------------------------------------------------------------------
# driver
# ---------------------------------------------------------------------------

def analyze_index(idx: PackageIndex,
                  rules: Iterable[str] | None = None,
                  entries: Iterable[tuple[str, str]] = HOT_ENTRIES
                  ) -> list[Finding]:
    wanted = set(rules) if rules is not None else set(DATAFLOW_RULE_NAMES)
    findings: list[Finding] = []
    if "blocking-in-hot-path" in wanted:
        findings.extend(check_blocking_in_hot_path(idx, entries))
    if "capture-hazard" in wanted:
        findings.extend(check_capture_hazard(idx))
    if "lock-order-static" in wanted:
        findings.extend(check_lock_order_static(idx))
    # honor # graftcheck: disable=RULE on the anchoring line
    suppress_cache: dict[str, tuple[dict[int, set[str]], set[str]]] = {}
    out: list[Finding] = []
    for f in findings:
        if f.path not in suppress_cache:
            for mi in idx.modules.values():
                if mi.path == f.path:
                    suppress_cache[f.path] = _suppressions(mi.src)
                    break
            else:
                suppress_cache[f.path] = ({}, set())
        per_line, per_file = suppress_cache[f.path]
        if f.rule in per_file or "all" in per_file:
            continue
        line_rules = per_line.get(f.line, set())
        if f.rule in line_rules or "all" in line_rules:
            continue
        out.append(f)
    out.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    return out


def analyze_paths(paths: Iterable[Path],
                  rules: Iterable[str] | None = None,
                  entries: Iterable[tuple[str, str]] = HOT_ENTRIES
                  ) -> list[Finding]:
    return analyze_index(build_index(paths), rules=rules, entries=entries)


def render(findings: list[Finding]) -> str:
    if not findings:
        return "graftcheck dataflow: clean"
    lines = [f.human() for f in findings]
    lines.append(f"graftcheck dataflow: {len(findings)} finding(s)")
    return "\n".join(lines)
