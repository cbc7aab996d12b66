"""PyTorch-aware AST lint: the rules ``compileall`` and pytest cannot see.

The bug classes that dominate risk in this codebase are not syntax errors:
a ``time.time()`` inside a CUDA graph's capture freezes one timestamp into
every replay; a pipe ``recv`` under a lock stalls every thread behind one
slow rank; a ``requests`` call under the metrics-manager lock stalls
every ``/metrics`` scrape behind a slow pod; a typo'd fault-point name
turns a chaos drill into a silent no-op.  Each rule here targets one such
class.

Rule framework: one class per rule (subclass :class:`Rule`, set ``name``
and implement ``check``); :data:`ALL_RULES` is the registry.  Suppression:

    x = risky()  # graftcheck: disable=lock-blocking-call -- reason

suppresses the named rule(s) on that line (comma-separated; ``all``
matches every rule), and a line anywhere in the file

    # graftcheck: disable-file=graph-host-read -- reason

suppresses a rule for the whole file.  A reason after ``--`` is
conventionally required by review, not enforced.

Used by the graftcheck CLI (human + JSON output) and unit-tested per rule
in tests/test_torch_graftcheck.py.
"""

from __future__ import annotations

import ast
import dataclasses
import json
import re
from pathlib import Path
from typing import Iterable, Iterator


@dataclasses.dataclass(frozen=True)
class Finding:
    path: str
    line: int
    col: int
    rule: str
    message: str

    def human(self) -> str:
        return f"{self.path}:{self.line}:{self.col}: [{self.rule}] {self.message}"

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


class Rule:
    """One lint rule.  ``check`` yields findings for a parsed module."""

    name = "abstract"
    description = ""

    def check(self, tree: ast.Module, path: str) -> Iterator[Finding]:
        raise NotImplementedError

    def finding(self, path: str, node: ast.AST, message: str) -> Finding:
        return Finding(path=path, line=getattr(node, "lineno", 1),
                       col=getattr(node, "col_offset", 0),
                       rule=self.name, message=message)


# ---------------------------------------------------------------------------
# shared AST helpers
# ---------------------------------------------------------------------------

def dotted_name(node: ast.AST) -> str:
    """``a.b.c`` for Name/Attribute chains; "" for anything else."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


def _is_graph_expr(node: ast.AST) -> bool:
    """True for a ``torch.cuda.graph(...)`` context expression (also
    ``cuda.graph(...)`` and a bare ``graph(...)`` imported from
    ``torch.cuda``)."""
    if not isinstance(node, ast.Call):
        return False
    return dotted_name(node.func) in ("torch.cuda.graph", "cuda.graph",
                                      "graph")


def _class_bases(tree: ast.Module) -> dict[str, list[str]]:
    return {n.name: [dotted_name(b).rsplit(".", 1)[-1] for b in n.bases]
            for n in ast.walk(tree) if isinstance(n, ast.ClassDef)}


def _subclasses(bases: dict[str, list[str]], cls: str) -> set[str]:
    """``cls`` and every class of the file that derives from it."""
    out = {cls}
    grew = True
    while grew:
        grew = False
        for name, bs in bases.items():
            if name not in out and out.intersection(bs):
                out.add(name)
                grew = True
    return out


def graph_bodies(tree: ast.Module) -> list[ast.AST]:
    """Nodes whose bodies run while a CUDA graph is captured:

    * every ``with torch.cuda.graph(...)`` block itself;
    * defs called by bare name inside such a block (every same-named def
      of the file: a file-local over-approximation, good enough for a
      lint);
    * methods called through ``self`` inside such a block: the method as
      the enclosing class resolves it (through its bases in the file) and
      every override in a subclass defined in the file
      (``_DecodeProgram._capture`` runs ``self._run()``, so
      ``_DecodeProgram._run`` and ``_SpecProgram._run`` are roots).

    What these read from the host is frozen into every replay of the
    graph: they are the graph's roots.
    """
    bodies: list[ast.AST] = []
    by_name: set[str] = set()
    by_method: set[tuple[str, str]] = set()
    classes = [n for n in ast.walk(tree) if isinstance(n, ast.ClassDef)]
    owner: dict[int, str] = {}
    for cls in classes:
        for sub in ast.walk(cls):
            owner.setdefault(id(sub), cls.name)
    for node in ast.walk(tree):
        if not (isinstance(node, (ast.With, ast.AsyncWith))
                and any(_is_graph_expr(i.context_expr) for i in node.items)):
            continue
        bodies.append(node)
        for sub in ast.walk(node):
            if not isinstance(sub, ast.Call):
                continue
            parts = dotted_name(sub.func).split(".")
            if len(parts) == 1 and parts[0]:
                by_name.add(parts[0])
            elif len(parts) == 2 and parts[0] == "self" \
                    and id(node) in owner:
                by_method.add((owner[id(node)], parts[1]))
    methods: dict[tuple[str, str], ast.AST] = {}
    for cls in classes:
        for fn in cls.body:
            if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                methods[(cls.name, fn.name)] = fn
    bases = _class_bases(tree)
    for cls, meth in sorted(by_method):
        queue = [cls]
        while queue:                    # the method the class resolves
            c = queue.pop(0)
            if (c, meth) in methods:
                bodies.append(methods[(c, meth)])
                break
            queue.extend(bases.get(c, []))
        for c in sorted(_subclasses(bases, cls) - {cls}):
            if (c, meth) in methods:    # and its overrides
                bodies.append(methods[(c, meth)])
    if by_name:
        for node in ast.walk(tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                    and node.name in by_name:
                bodies.append(node)
    out: list[ast.AST] = []
    for b in bodies:
        if b not in out:
            out.append(b)
    return out


#: ``torch.distributed`` calls that wait for every rank of the group.
COLLECTIVES = frozenset({
    "all_reduce", "all_gather", "all_gather_into_tensor",
    "all_gather_object", "reduce_scatter", "reduce_scatter_tensor",
    "broadcast", "broadcast_object_list", "barrier", "monitored_barrier",
    "all_to_all", "all_to_all_single", "gather", "scatter", "reduce",
    "send", "recv",
})


def is_collective(call: ast.Call) -> bool:
    """A ``torch.distributed`` collective, called as ``dist.<op>`` or
    ``torch.distributed.<op>``."""
    parts = dotted_name(call.func).split(".")
    return len(parts) >= 2 and parts[-1] in COLLECTIVES \
        and parts[-2] in ("dist", "distributed")


#: Device->host reads of a tensor: each waits for the stream, and inside a
#: capture it fails (or replays what the tensor held at capture time).
SYNC_METHODS = ("item", "tolist", "cpu", "numpy")


def host_read(call: ast.Call) -> str:
    """The host state a call reads (``time.*``, ``datetime.now``,
    ``os.getenv``, ``random.*``, ``np.random.*``, a ``.seed`` call), or ""
    for none."""
    dn = dotted_name(call.func)
    parts = dn.split(".")
    if len(parts) == 2 and parts[0] in ("time", "random"):
        return dn
    if len(parts) >= 3 and parts[0] in ("np", "numpy") \
            and parts[1] == "random":
        return dn
    if dn in ("datetime.now", "datetime.utcnow", "datetime.datetime.now",
              "datetime.datetime.utcnow", "os.getenv", "os.environb") \
            or dn.endswith(".seed"):
        return dn
    return ""


def device_sync(call: ast.Call) -> str:
    """The device->host read a call makes: ``.item()``, ``.tolist()``,
    ``.cpu()``, ``.numpy()`` or ``.to("cpu")`` of a tensor, or a
    ``synchronize`` (``torch.cuda.synchronize``, ``Event.synchronize``,
    ``Stream.synchronize``); "" for none."""
    if not isinstance(call.func, ast.Attribute):
        return ""
    leaf = call.func.attr
    label = dotted_name(call.func) or f"<expr>.{leaf}"
    if leaf in SYNC_METHODS and not call.args:
        return label
    if leaf == "synchronize":
        return label
    if leaf == "to" and call.args \
            and isinstance(call.args[0], ast.Constant) \
            and call.args[0].value == "cpu":
        return label
    return ""


# ---------------------------------------------------------------------------
# rules
# ---------------------------------------------------------------------------

class GraphHostReadRule(Rule):
    """No host reads inside a CUDA graph's roots.

    A captured graph replays the kernels its capture launched, on the
    addresses they read: ``time.time()`` / ``os.environ[...]`` /
    ``random.random()`` run once, at capture, and their value is frozen
    into every replay; ``.item()`` / ``.tolist()`` / ``.cpu()`` read a
    tensor back to the host, which a capture refuses (or, outside it, a
    value read once).  Host state belongs outside the capture, copied into
    the graph's static input buffers before replay.
    """

    name = "graph-host-read"
    description = ("host read (clock/env/RNG/tensor read-back) inside a "
                   "CUDA graph's capture")

    def check(self, tree: ast.Module, path: str) -> Iterator[Finding]:
        for body in graph_bodies(tree):
            for node in ast.walk(body):
                if isinstance(node, ast.Call):
                    dn = host_read(node)
                    if dn:
                        yield self.finding(
                            path, node,
                            f"'{dn}()' inside a CUDA graph's capture is "
                            f"frozen into every replay; copy the value "
                            f"into a static input buffer before replay")
                        continue
                    dn = device_sync(node)
                    if dn and not dn.endswith("synchronize"):
                        yield self.finding(
                            path, node,
                            f"'{dn}()' reads a tensor back to the host "
                            f"inside a CUDA graph's capture: the capture "
                            f"fails, or every replay reuses one value")
                elif isinstance(node, (ast.Attribute, ast.Name)):
                    if dotted_name(node) == "os.environ":
                        yield self.finding(
                            path, node,
                            "'os.environ' read inside a CUDA graph's "
                            "capture; resolve env config before capture")


class LockBlockingCallRule(Rule):
    """No blocking calls while a lock is held.

    A sleep, HTTP request, socket connect, subprocess, pipe receive,
    collective or device->host read under a lock turns every other thread
    contending for that lock into a convoy — on the serving plane that is
    the difference between a slow scrape and a wedged step loop.  Move the blocking work outside
    the critical section (snapshot under the lock, act after release).

    Heuristics: a ``with`` context whose expression's terminal name
    contains ``lock``, ``mutex``, or ``cond`` is treated as a lock;
    nested function bodies are skipped (closures usually run later,
    outside the lock).
    """

    name = "lock-blocking-call"
    description = ("blocking call (sleep/HTTP/socket/pipe/collective/"
                   "device sync) under a lock")

    _CALLS = {
        "time.sleep", "sleep",
        "socket.create_connection", "socket.getaddrinfo",
        "urllib.request.urlopen", "urlopen",
        "subprocess.run", "subprocess.Popen", "subprocess.check_output",
        "subprocess.check_call", "subprocess.call",
    }
    _REQUESTS_VERBS = {"get", "post", "put", "delete", "head", "patch",
                       "request"}
    # multiprocessing.Connection: a receive waits for the other end.
    _METHOD_SUFFIXES = ("recv", "recv_bytes")

    @staticmethod
    def _is_lock_ctx(expr: ast.AST) -> bool:
        dn = dotted_name(expr)
        leaf = dn.rsplit(".", 1)[-1].lower()
        return any(k in leaf for k in ("lock", "mutex", "cond"))

    def _is_blocking(self, call: ast.Call) -> str:
        dn = dotted_name(call.func)
        if dn in self._CALLS:
            return dn
        parts = dn.split(".")
        if len(parts) >= 2 and parts[-2] == "requests" \
                and parts[-1] in self._REQUESTS_VERBS:
            return dn
        if parts[-1] in self._METHOD_SUFFIXES:
            return dn
        if parts[-1] == "join" and len(parts) >= 2 \
                and "thread" in parts[-2].lower():
            return dn
        if is_collective(call):
            return dn
        # Device->host reads wait for every kernel queued before them;
        # under a lock that risk is never worth it.
        return device_sync(call)

    def check(self, tree: ast.Module, path: str) -> Iterator[Finding]:
        for node in ast.walk(tree):
            if not isinstance(node, (ast.With, ast.AsyncWith)):
                continue
            if not any(self._is_lock_ctx(item.context_expr)
                       for item in node.items):
                continue
            stack: list[ast.AST] = list(node.body)
            while stack:
                sub = stack.pop()
                if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef,
                                    ast.Lambda)):
                    continue  # runs later, usually outside the lock
                if isinstance(sub, ast.Call):
                    dn = self._is_blocking(sub)
                    if dn:
                        yield self.finding(
                            path, sub,
                            f"blocking call '{dn}' while holding a lock; "
                            f"move it outside the critical section")
                stack.extend(ast.iter_child_nodes(sub))


class BareExceptRule(Rule):
    """No bare ``except:`` and no swallowed ``BaseException``.

    Both catch ``KeyboardInterrupt``/``SystemExit`` and — in this codebase
    — ``FaultError`` injections, turning a chaos drill into a silent pass.
    Catch ``Exception`` (or narrower), or re-raise.
    """

    name = "bare-except"
    description = "bare except / swallowed BaseException"

    @staticmethod
    def _reraises(handler: ast.ExceptHandler) -> bool:
        for node in ast.walk(handler):
            if isinstance(node, ast.Raise):
                return True
        return False

    def check(self, tree: ast.Module, path: str) -> Iterator[Finding]:
        for node in ast.walk(tree):
            if not isinstance(node, ast.ExceptHandler):
                continue
            if node.type is None:
                if not self._reraises(node):
                    yield self.finding(
                        path, node,
                        "bare 'except:' swallows BaseException (incl. "
                        "KeyboardInterrupt and injected faults); catch "
                        "Exception or re-raise")
            elif dotted_name(node.type).endswith("BaseException"):
                if not self._reraises(node):
                    yield self.finding(
                        path, node,
                        "'except BaseException' without re-raise; catch "
                        "Exception or re-raise")


class MutableDefaultRule(Rule):
    """No mutable default arguments (shared across calls)."""

    name = "mutable-default"
    description = "mutable default argument"

    _MUTABLE_CALLS = {"list", "dict", "set", "defaultdict", "deque",
                      "Counter", "OrderedDict"}

    def _is_mutable(self, node: ast.AST) -> bool:
        if isinstance(node, (ast.List, ast.Dict, ast.Set, ast.ListComp,
                             ast.DictComp, ast.SetComp)):
            return True
        if isinstance(node, ast.Call):
            dn = dotted_name(node.func)
            return dn.rsplit(".", 1)[-1] in self._MUTABLE_CALLS
        return False

    def check(self, tree: ast.Module, path: str) -> Iterator[Finding]:
        for node in ast.walk(tree):
            if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                     ast.Lambda)):
                continue
            args = node.args
            for default in list(args.defaults) + [
                    d for d in args.kw_defaults if d is not None]:
                if self._is_mutable(default):
                    yield self.finding(
                        path, default,
                        "mutable default argument is shared across calls; "
                        "default to None (or a dataclasses.field factory)")


class FaultPointRule(Rule):
    """Every fault-point name must exist in the central registry.

    ``get_injector().arm("decode_dispach")`` (typo) raises at arm time,
    but hooks like ``self._faults.maybe_raise("decode_dispach")`` planted
    in rarely-exercised paths would just never fire.  This rule checks
    every string literal passed to the injector API against
    ``resilience.faults.FAULT_POINTS``.
    """

    name = "fault-point"
    description = "fault-point name not in resilience.faults.FAULT_POINTS"

    _ALWAYS = {"maybe_raise", "should_fire", "delay_s"}
    _HINTED = {"arm", "disarm", "fired"}
    _RECEIVER_HINTS = ("fault", "injector", "inj")

    def __init__(self, points: frozenset[str] | None = None):
        if points is None:
            from ..resilience.faults import FAULT_POINTS
            points = FAULT_POINTS
        self._points = points

    def check(self, tree: ast.Module, path: str) -> Iterator[Finding]:
        for node in ast.walk(tree):
            if not (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)):
                continue
            attr = node.func.attr
            if attr not in self._ALWAYS and attr not in self._HINTED:
                continue
            if attr in self._HINTED:
                recv = dotted_name(node.func.value).lower()
                if isinstance(node.func.value, ast.Call):
                    recv = dotted_name(node.func.value.func).lower()
                if not any(h in recv for h in self._RECEIVER_HINTS):
                    continue
            if not node.args:
                continue
            arg = node.args[0]
            if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
                if arg.value not in self._points:
                    yield self.finding(
                        path, arg,
                        f"fault point {arg.value!r} is not declared in "
                        f"resilience.faults.FAULT_POINTS — a typo here "
                        f"makes the hook silently never fire")


class RawLockRule(Rule):
    """Locks must come from ``devtools.lockcheck.make_lock``.

    A raw ``threading.Lock()`` bypasses the lockcheck instrumentation:
    ``K8SLLM_LOCKCHECK=1`` chaos runs can't see its hold times or
    ``@guarded_by`` violations, so a subsystem built on raw locks gets no
    race coverage at all.  ``lockcheck.py`` itself (the factory) is the
    one legitimate construction site.
    """

    name = "raw-lock"
    description = "raw threading.Lock() outside devtools.lockcheck"

    _LOCK_CALLS = {"threading.Lock", "threading.RLock"}

    @staticmethod
    def _threading_imports(tree: ast.Module) -> set[str]:
        """Local names bound to threading.Lock/RLock via from-imports."""
        names: set[str] = set()
        for node in ast.walk(tree):
            if isinstance(node, ast.ImportFrom) and node.module == "threading":
                for alias in node.names:
                    if alias.name in ("Lock", "RLock"):
                        names.add(alias.asname or alias.name)
        return names

    def check(self, tree: ast.Module, path: str) -> Iterator[Finding]:
        if path.replace("\\", "/").endswith("devtools/lockcheck.py"):
            return
        bare = self._threading_imports(tree)
        for node in ast.walk(tree):
            if not isinstance(node, ast.Call):
                continue
            dn = dotted_name(node.func)
            # ``bare`` holds only names bound from threading.Lock/RLock
            # (including asnames), so membership alone marks a lock call.
            if dn in self._LOCK_CALLS or dn in bare:
                yield self.finding(
                    path, node,
                    f"raw {dn}() bypasses lockcheck instrumentation; use "
                    f"devtools.lockcheck.make_lock(name) so "
                    f"K8SLLM_LOCKCHECK=1 runs can audit it")


class UnconstrainedParseRule(Rule):
    """Model output must be parsed through ``diagnosis.grammar``.

    A ``json.loads`` on LLM-generated text is a latent 500: free-running
    decode produces almost-JSON often enough to pass review and rarely
    enough to page at 3am.  The sanctioned path is FSM-constrained decode
    plus ``diagnosis.grammar.parse_verdict`` (which validates against the
    same DFA before parsing) — ``diagnosis/grammar.py`` is therefore the
    one file allowed to call ``json.loads`` on model text.

    Heuristics: a ``json.loads`` call is treated as parsing model output
    when it sits inside a class that looks like an LLM provider adapter
    (name ends with ``Backend`` *and* defines ``generate`` — which keeps
    ``KubeRestBackend`` out), or when its argument's name carries a
    model-output marker (``answer``, ``verdict``, ``completion``,
    ``generated`` …).
    Request-body parsing (``_read_json`` in the HTTP server) matches
    neither and stays unflagged.  Protocol-level parses inside a Backend
    (e.g. an OpenAI-compat HTTP envelope) suppress with
    ``# graftcheck: disable=unconstrained-model-parse -- reason``.
    """

    name = "unconstrained-model-parse"
    description = "json.loads of model output outside diagnosis/grammar.py"

    _MARKERS = ("answer", "verdict", "completion", "generated",
                "generation", "model_output", "llm_text")

    @staticmethod
    def _loads_names(tree: ast.Module) -> set[str]:
        """Local names bound to json.loads via from-imports."""
        names: set[str] = set()
        for node in ast.walk(tree):
            if isinstance(node, ast.ImportFrom) and node.module == "json":
                for alias in node.names:
                    if alias.name == "loads":
                        names.add(alias.asname or alias.name)
        return names

    def _is_loads(self, call: ast.Call, bare: set[str]) -> bool:
        dn = dotted_name(call.func)
        return dn == "json.loads" or dn in bare

    def _arg_marker(self, call: ast.Call) -> str:
        if not call.args:
            return ""
        # Strip decode()/strip() chains: json.loads(raw_answer.strip()).
        arg = call.args[0]
        while isinstance(arg, ast.Call):
            arg = arg.func
        label = dotted_name(arg).lower()
        for marker in self._MARKERS:
            if marker in label:
                return marker
        return ""

    def check(self, tree: ast.Module, path: str) -> Iterator[Finding]:
        if path.replace("\\", "/").endswith("diagnosis/grammar.py"):
            return  # the sanctioned parser
        bare = self._loads_names(tree)
        in_backend: set[int] = set()
        for cls in ast.walk(tree):
            if not (isinstance(cls, ast.ClassDef)
                    and cls.name.endswith("Backend")):
                continue
            if not any(isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef))
                       and m.name == "generate" for m in cls.body):
                continue  # e.g. KubeRestBackend: no LLM here
            for sub in ast.walk(cls):
                in_backend.add(id(sub))
        for node in ast.walk(tree):
            if not (isinstance(node, ast.Call)
                    and self._is_loads(node, bare)):
                continue
            marker = self._arg_marker(node)
            if id(node) in in_backend:
                yield self.finding(
                    path, node,
                    "json.loads inside an LLM backend class parses model "
                    "output unconstrained; use FSM-constrained decode + "
                    "diagnosis.grammar.parse_verdict, or suppress for "
                    "protocol-envelope parses")
            elif marker:
                yield self.finding(
                    path, node,
                    f"json.loads of '{marker}'-named value looks like "
                    f"free-running model output; route it through "
                    f"diagnosis.grammar.parse_verdict so malformed JSON "
                    f"cannot reach callers")


class TenantNamespaceRule(Rule):
    """Prefix-KV key and blob paths must carry the tenant namespace.

    The multi-tenant privacy invariant is structural: ``PrefixCache``
    digests are seeded per tenant and ``KVX1`` blobs carry a tenant tag,
    so a cross-tenant hit is impossible — *if* every call site passes the
    tenant through.  A lookup/register/spill/migration call that omits it
    silently lands in the default namespace, which either leaks one
    tenant's prefix into another's accounting or (worse) bypasses the
    per-tenant eviction cap.  This rule makes the omission a lint error
    instead of a code-review hope.

    Heuristics: ``lookup`` / ``register`` / ``digest_chain`` on a
    receiver that looks like a prefix cache (leaf name ``pc`` or
    containing ``prefix``/``cache``), ``put`` on a tier-like receiver,
    and any ``export_prefix`` / ``fetch_prefix`` / ``install_prefix``
    call must pass ``tenant=`` (``install_prefix`` accepts
    ``expected_tenant=``).  A ``**kwargs`` splat counts as satisfied
    (not analyzable).  The defining modules — ``serving/kv_cache.py``,
    ``serving/kv_tier.py``, ``resilience/tenancy.py`` — are exempt.
    """

    name = "tenant-namespace"
    description = "prefix-KV key/blob path without tenant namespacing"

    _PC_METHODS = {"lookup", "register", "digest_chain"}
    _TIER_METHODS = {"put"}
    _BLOB_METHODS = {"export_prefix": ("tenant",),
                     "fetch_prefix": ("tenant",),
                     "install_prefix": ("tenant", "expected_tenant")}
    _EXEMPT = ("serving/kv_cache.py", "serving/kv_tier.py",
               "resilience/tenancy.py")

    @staticmethod
    def _leaf(expr: ast.AST) -> str:
        return dotted_name(expr).rsplit(".", 1)[-1].lower()

    @classmethod
    def _is_pc_recv(cls, expr: ast.AST) -> bool:
        leaf = cls._leaf(expr)
        return leaf == "pc" or "prefix" in leaf or "cache" in leaf

    @classmethod
    def _is_tier_recv(cls, expr: ast.AST) -> bool:
        return "tier" in cls._leaf(expr)

    @staticmethod
    def _has_kw(call: ast.Call, accepted: tuple[str, ...]) -> bool:
        for kw in call.keywords:
            if kw.arg is None:  # **kwargs splat: assume it's in there
                return True
            if kw.arg in accepted:
                return True
        return False

    def check(self, tree: ast.Module, path: str) -> Iterator[Finding]:
        norm = path.replace("\\", "/")
        if any(norm.endswith(e) for e in self._EXEMPT):
            return  # the namespacing implementations themselves
        for node in ast.walk(tree):
            if not (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)):
                continue
            attr = node.func.attr
            if attr in self._BLOB_METHODS:
                accepted = self._BLOB_METHODS[attr]
                if not self._has_kw(node, accepted):
                    yield self.finding(
                        path, node,
                        f"'{attr}()' without {' / '.join(accepted)}= moves "
                        f"a KV blob outside the tenant namespace; pass the "
                        f"request's tenant through")
            elif attr in self._PC_METHODS \
                    and self._is_pc_recv(node.func.value):
                if not self._has_kw(node, ("tenant",)):
                    yield self.finding(
                        path, node,
                        f"prefix-cache '{attr}()' without tenant= lands in "
                        f"the default namespace — cross-tenant prefix "
                        f"leak; pass tenant= through from the request")
            elif attr in self._TIER_METHODS \
                    and self._is_tier_recv(node.func.value):
                if not self._has_kw(node, ("tenant",)):
                    yield self.finding(
                        path, node,
                        "host-tier 'put()' without tenant= skips per-"
                        "tenant byte accounting and the max-share cap; "
                        "tag the spill with the owning tenant")


class RawKubeWriteRule(Rule):
    """Cluster mutations must flow through the sanctioned executors.

    The remediation executor earns its safety claims structurally:
    every write is dry-run-validated first, breaker-guarded, rate
    limited, idempotency-keyed, and (for destructive verbs) approval
    gated.  A mutation issued from anywhere else skips all of that —
    one stray ``delete_pod()`` in a handler and the audit trail, the
    replay protection, and the approval gate are fiction.  This rule
    flags the two ways a write can escape:

    * a call to one of the mutation verbs — ``scale_statefulset``,
      ``rollout_restart``, ``cordon_node``, ``delete_pod`` — on any
      receiver;
    * a ``_request(...)`` call passing ``method=`` POST/PATCH/DELETE
      (the raw kube REST write path).

    Exempt: ``remediation/executor.py`` (the executor itself),
    ``fleet/autoscaler.py`` (``KubeScaleExecutor``, the pre-existing
    sanctioned scale path), and the backends that *implement* the
    verbs (``monitor/kube_rest.py``, ``monitor/cluster.py``).  Test
    files are skipped — they drive fakes, not clusters.
    """

    name = "raw-kube-write"
    description = "kube mutation outside the sanctioned executors"

    _VERBS = {"scale_statefulset", "rollout_restart", "cordon_node",
              "delete_pod"}
    _WRITE_METHODS = {"POST", "PATCH", "DELETE"}
    _EXEMPT = ("remediation/executor.py", "fleet/autoscaler.py",
               "monitor/kube_rest.py", "monitor/cluster.py")

    def check(self, tree: ast.Module, path: str) -> Iterator[Finding]:
        norm = path.replace("\\", "/")
        if any(norm.endswith(e) for e in self._EXEMPT):
            return  # the sanctioned executors / verb implementations
        base = norm.rsplit("/", 1)[-1]
        if base.startswith("test_") or "/tests/" in norm:
            return  # tests drive FakeCluster directly by design
        for node in ast.walk(tree):
            if not (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)):
                continue
            attr = node.func.attr
            if attr in self._VERBS:
                yield self.finding(
                    path, node,
                    f"'{attr}()' mutates the cluster outside "
                    f"remediation.executor / KubeScaleExecutor — this "
                    f"skips dry-run validation, breakers, rate limits "
                    f"and the approval gate; route it through "
                    f"RemediationEngine")
            elif attr == "_request":
                for kw in node.keywords:
                    if kw.arg == "method" \
                            and isinstance(kw.value, ast.Constant) \
                            and str(kw.value.value).upper() \
                            in self._WRITE_METHODS:
                        yield self.finding(
                            path, node,
                            f"raw kube {kw.value.value} via _request() "
                            f"bypasses every remediation guard; add a "
                            f"verb to KubeRestBackend and call it from "
                            f"the executor instead")
                        break


def default_rules() -> list[Rule]:
    return [GraphHostReadRule(), LockBlockingCallRule(), BareExceptRule(),
            MutableDefaultRule(), FaultPointRule(), RawLockRule(),
            UnconstrainedParseRule(), TenantNamespaceRule(),
            RawKubeWriteRule()]


ALL_RULE_NAMES = tuple(r.name for r in default_rules())


# ---------------------------------------------------------------------------
# suppression + driver
# ---------------------------------------------------------------------------

_SUPPRESS_RE = re.compile(
    r"#\s*graftcheck:\s*(disable|disable-file)\s*=\s*([\w,\-]+)")


def _suppressions(src: str) -> tuple[dict[int, set[str]], set[str]]:
    """(per-line rule sets, whole-file rule set) from magic comments."""
    per_line: dict[int, set[str]] = {}
    per_file: set[str] = set()
    for lineno, line in enumerate(src.splitlines(), start=1):
        m = _SUPPRESS_RE.search(line)
        if not m:
            continue
        rules = {r.strip() for r in m.group(2).split(",") if r.strip()}
        if m.group(1) == "disable-file":
            per_file |= rules
        else:
            per_line.setdefault(lineno, set()).update(rules)
    return per_line, per_file


def lint_source(src: str, path: str = "<string>",
                rules: Iterable[Rule] | None = None) -> list[Finding]:
    """Lint one source blob; returns unsuppressed findings sorted by
    position.  Syntax errors come back as a single ``parse-error``
    finding (compileall-grade breakage still surfaces through the lint)."""
    try:
        tree = ast.parse(src)
    except SyntaxError as exc:
        return [Finding(path=path, line=exc.lineno or 1,
                        col=exc.offset or 0, rule="parse-error",
                        message=str(exc.msg))]
    per_line, per_file = _suppressions(src)
    out: list[Finding] = []
    for rule in (rules if rules is not None else default_rules()):
        for f in rule.check(tree, path):
            if f.rule in per_file or "all" in per_file:
                continue
            line_rules = per_line.get(f.line, set())
            if f.rule in line_rules or "all" in line_rules:
                continue
            out.append(f)
    out.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    return out


def iter_py_files(root: Path) -> Iterator[Path]:
    if root.is_file():
        if root.suffix == ".py":
            yield root
        return
    for p in sorted(root.rglob("*.py")):
        if "__pycache__" in p.parts:
            continue
        yield p


def lint_paths(paths: Iterable[Path],
               rules: Iterable[Rule] | None = None) -> list[Finding]:
    rules = list(rules) if rules is not None else default_rules()
    findings: list[Finding] = []
    for root in paths:
        for p in iter_py_files(Path(root)):
            findings.extend(
                lint_source(p.read_text(encoding="utf-8"), str(p), rules))
    return findings


def render(findings: list[Finding], as_json: bool = False) -> str:
    if as_json:
        return json.dumps({
            "findings": [f.as_dict() for f in findings],
            "count": len(findings),
            "ok": not findings,
        }, indent=2)
    if not findings:
        return "graftcheck astlint: clean"
    lines = [f.human() for f in findings]
    lines.append(f"graftcheck astlint: {len(findings)} finding(s)")
    return "\n".join(lines)
