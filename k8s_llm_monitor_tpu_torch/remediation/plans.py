"""Action-plan grammar: bounded kubectl verbs over live-state targets.

The diagnosis pipeline ends at a verdict; this module defines the *plan*
language that turns verdicts into executable actions.  The design point is
that the model is structurally unable to name anything that does not
exist: every target (pod, node, workload, statefulset) is enumerated from
a ``TargetSnapshot`` of live cluster state and baked into the schema as an
enum, so the compiled grammar only admits plans against real resources.

The schema is an ``anyOf`` of one object shape per verb — each verb only
admits its own target kind (a ``cordon`` cannot name a pod, a
``delete_pod`` cannot name a node) — compiled through the grammar
compiler (``diagnosis/grammar.py``) into a char DFA and lifted to a token
FSM for on-device constrained decode.

Zero recompiles across snapshots: plan FSM transition tables are padded to
a fixed ``[PLAN_STATE_CAP + 1, vocab]`` shape (padding rows are
unreachable, so semantics are untouched).  The engine's decode program
treats the table as a runtime argument keyed by shape, so swapping one
snapshot's plan grammar for another's — or alternating with the verdict
grammar — never triggers a new XLA compile after first warm-up
(``devtools/traceguard.py`` ``grammar_swap`` path proves it).

``parse_plan`` funnels through ``grammar.parse_with_dfa`` — the one
sanctioned ``json.loads`` — then re-checks every target against the
snapshot, defense in depth for plans arriving from non-FSM backends.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Any

import numpy as np

from k8s_llm_monitor_tpu_torch.diagnosis.grammar import (
    CharDFA,
    GrammarError,
    TokenFSM,
    compile_schema,
    parse_with_dfa,
    token_fsm,
)

__all__ = [
    "PLAN_VERBS",
    "DESTRUCTIVE_VERBS",
    "PLAN_STATE_CAP",
    "MAX_REPLICAS",
    "REASON_MAX_CHARS",
    "TargetSnapshot",
    "build_plan_schema",
    "plan_dfa",
    "plan_fsm",
    "parse_plan",
    "render_plan",
    "propose_plan",
    "workload_of",
]

#: The closed verb set.  Order matters only for docs; the grammar is an
#: alternation.  ``noop`` is always admissible — a planner that has nothing
#: safe to do must still be able to close the object.
PLAN_VERBS = ("scale", "rollout_restart", "cordon", "delete_pod", "noop")

#: Verbs that remove capacity or workloads: refused without an approval
#: (K8SLLM_REMEDIATE_APPROVE=1 or per-plan approve via the HTTP API).
DESTRUCTIVE_VERBS = frozenset({"cordon", "delete_pod"})

#: Fixed token-FSM row count every plan grammar is padded to.  One shape →
#: one compiled decode variant → snapshot-to-snapshot grammar swaps are
#: recompile-free.  Sized ~2x the largest grammar the default enumeration
#: caps can produce; ``plan_fsm`` raises before silently truncating.
PLAN_STATE_CAP = 4096

#: Bounded replica range for the ``scale`` verb (enumerated literals in
#: the grammar — the model cannot ask for 10^9 replicas).
MAX_REPLICAS = 16

REASON_MAX_CHARS = 96

# Enumeration caps: bound the DFA size no matter how big the cluster is.
# Selection under pressure keeps the *interesting* entries (non-Running
# pods first), so caps trim healthy bulk, not the incident.
MAX_PODS = 24
MAX_NODES = 12
MAX_WORKLOADS = 12
MAX_STATEFULSETS = 8
MAX_NAMESPACES = 8

_HASHY = re.compile(r"^[a-z0-9]{4,10}$")


def workload_of(pod_name: str) -> str:
    """Controller-ish workload name for a pod: strip up to two trailing
    hash-like segments (``web-frontend-7d4b9c6f5-x2x1p`` → ``web-frontend``).
    Heuristic by design — the snapshot only uses it to *enumerate* restart
    targets; execution matches pods back by prefix."""
    parts = pod_name.split("-")
    for _ in range(2):
        if len(parts) > 1 and _HASHY.match(parts[-1]) \
                and any(c.isdigit() for c in parts[-1]):
            parts.pop()
    return "-".join(parts)


@dataclass(frozen=True)
class TargetSnapshot:
    """Frozen enumeration of live targets a plan may name.

    Entries are ``"namespace/name"`` refs (pods, workloads, statefulsets)
    or bare node names, pre-joined so the grammar admits only valid
    namespace+name *pairs* — separate enums would let the model cross
    them.  ``statefulset_replicas`` carries observed replica counts for
    the deterministic planner's scale proposals.
    """

    pods: tuple[str, ...] = ()
    nodes: tuple[str, ...] = ()
    workloads: tuple[str, ...] = ()
    statefulsets: tuple[str, ...] = ()
    statefulset_replicas: dict[str, int] = field(default_factory=dict)

    def key(self) -> tuple:
        """Cache key for the compiled grammar (replica counts don't change
        the admitted language)."""
        return (self.pods, self.nodes, self.workloads, self.statefulsets)

    @classmethod
    def from_backend(cls, backend, namespaces: list[str] | tuple[str, ...],
                     ) -> "TargetSnapshot":
        """Enumerate targets through the ``ClusterBackend`` seam.  Reads
        are best-effort per kind: a failing list degrades that verb's
        target set to empty (its grammar arm drops out) instead of failing
        the plan stage outright."""
        namespaces = list(namespaces)[:MAX_NAMESPACES] or ["default"]
        pods: list[tuple[bool, str]] = []
        workloads: list[str] = []
        nodes: list[str] = []
        stss: list[str] = []
        replicas: dict[str, int] = {}
        for ns in namespaces:
            try:
                listed = backend.list_pods(ns)
            except Exception:  # noqa: BLE001 — degrade per kind
                listed = []
            for pod in listed:
                name = (pod.get("metadata") or {}).get("name", "")
                if not name or not _ref_ok(name):
                    continue
                phase = (pod.get("status") or {}).get("phase", "")
                # Unhealthy pods sort first so caps keep the incident.
                pods.append((phase == "Running", f"{ns}/{name}"))
                wl = f"{ns}/{workload_of(name)}"
                if wl not in workloads and _ref_ok(wl):
                    workloads.append(wl)
        try:
            listed_nodes = backend.list_nodes()
        except Exception:  # noqa: BLE001
            listed_nodes = []
        for node in listed_nodes:
            name = (node.get("metadata") or {}).get("name", "")
            if name and _ref_ok(name):
                nodes.append(name)
        lister = getattr(backend, "list_statefulsets", None)
        if callable(lister):
            for ns in namespaces:
                try:
                    listed_sts = lister(ns)
                except Exception:  # noqa: BLE001
                    listed_sts = []
                for sts in listed_sts:
                    name = (sts.get("metadata") or {}).get("name", "")
                    if not name or not _ref_ok(name):
                        continue
                    ref = f"{ns}/{name}"
                    stss.append(ref)
                    spec = sts.get("spec") or {}
                    replicas[ref] = int(spec.get("replicas", 0))
        pods.sort()  # False (non-Running) before True
        return cls(
            pods=tuple(ref for _, ref in pods[:MAX_PODS]),
            nodes=tuple(sorted(nodes)[:MAX_NODES]),
            workloads=tuple(sorted(workloads)[:MAX_WORKLOADS]),
            statefulsets=tuple(sorted(stss)[:MAX_STATEFULSETS]),
            statefulset_replicas=replicas,
        )


_REF_RE = re.compile(r"^[A-Za-z0-9._/-]+$")


def _ref_ok(ref: str) -> bool:
    """Targets must fit the grammar's JSON-safe charset; k8s DNS names
    always do — this guards against exotic CR names leaking in."""
    return bool(_REF_RE.match(ref)) and len(ref) <= 96


def build_plan_schema(snapshot: TargetSnapshot) -> dict[str, Any]:
    """The ``anyOf``-of-verbs schema for one snapshot.  Verb arms with no
    live targets drop out entirely (an empty enum is uncompilable and
    would be meaningless anyway); ``noop`` is always present."""
    reason = {"type": "string", "minLength": 1,
              "maxLength": REASON_MAX_CHARS}
    arms: list[dict[str, Any]] = []
    if snapshot.statefulsets:
        arms.append({"type": "object", "properties": {
            "verb": {"enum": ["scale"]},
            "target": {"enum": list(snapshot.statefulsets)},
            "replicas": {"type": "integer", "minimum": 0,
                         "maximum": MAX_REPLICAS},
            "reason": reason,
        }})
    if snapshot.workloads:
        arms.append({"type": "object", "properties": {
            "verb": {"enum": ["rollout_restart"]},
            "target": {"enum": list(snapshot.workloads)},
            "reason": reason,
        }})
    if snapshot.nodes:
        arms.append({"type": "object", "properties": {
            "verb": {"enum": ["cordon"]},
            "target": {"enum": list(snapshot.nodes)},
            "reason": reason,
        }})
    if snapshot.pods:
        arms.append({"type": "object", "properties": {
            "verb": {"enum": ["delete_pod"]},
            "target": {"enum": list(snapshot.pods)},
            "reason": reason,
        }})
    arms.append({"type": "object", "properties": {
        "verb": {"enum": ["noop"]},
        "reason": reason,
    }})
    return {"anyOf": arms}


# Compiled-grammar caches, keyed by snapshot content.  Bounded: plan
# grammars are per-incident, not per-request, and each padded FSM is a few
# MB — keep the last few snapshots warm, drop the oldest beyond that.
_DFA_CACHE: dict[tuple, CharDFA] = {}
_FSM_CACHE: dict[tuple, TokenFSM] = {}
_CACHE_CAP = 4


def _cache_put(cache: dict, key: tuple, value) -> None:
    if key not in cache and len(cache) >= _CACHE_CAP:
        cache.pop(next(iter(cache)))
    cache[key] = value


def plan_dfa(snapshot: TargetSnapshot) -> CharDFA:
    key = snapshot.key()
    dfa = _DFA_CACHE.get(key)
    if dfa is None:
        dfa = compile_schema(build_plan_schema(snapshot))
        _cache_put(_DFA_CACHE, key, dfa)
    return dfa


def plan_fsm(snapshot: TargetSnapshot, *, eos_id: int = 2,
             vocab_size: int = 259) -> TokenFSM:
    """Padded token FSM for one snapshot's plan grammar.

    Rows are padded to ``PLAN_STATE_CAP + 1`` with all-disallowed (-1)
    entries — unreachable from any live state, so the admitted language is
    exactly the unpadded grammar's.  The fixed shape is the recompile-free
    contract: every snapshot's plan FSM is the same ``[rows, vocab]``
    runtime argument to the decode program.
    """
    key = snapshot.key() + (eos_id, vocab_size)
    fsm = _FSM_CACHE.get(key)
    if fsm is not None:
        return fsm
    base = token_fsm(plan_dfa(snapshot), eos_id=eos_id,
                     vocab_size=vocab_size)
    rows = PLAN_STATE_CAP + 1
    if base.trans.shape[0] > rows:
        raise GrammarError(
            f"plan grammar needs {base.trans.shape[0]} states "
            f"(cap {rows}); lower the snapshot enumeration caps")
    trans = np.full((rows, vocab_size), -1, dtype=np.int32)
    trans[: base.trans.shape[0]] = base.trans
    accept = np.zeros(rows, dtype=bool)
    accept[: base.accept.shape[0]] = base.accept
    fsm = TokenFSM(trans=trans, start=base.start, accept=accept,
                   eos_id=eos_id, max_len=base.max_len)
    _cache_put(_FSM_CACHE, key, fsm)
    return fsm


def parse_plan(text: str, snapshot: TargetSnapshot) -> dict[str, Any]:
    """Grammar-validate, parse, and semantically check one plan.

    Returns ``{"verb", "namespace", "name", "replicas", "reason"}``
    (namespace empty for node targets and noop).  Raises ``GrammarError``
    for anything the constrained sampler could not have produced *or*
    whose target is not in the snapshot — the latter is unreachable for
    FSM-decoded plans and exists for render-path backends.
    """
    plan = parse_with_dfa(text, plan_dfa(snapshot))
    verb = plan.get("verb", "")
    if verb not in PLAN_VERBS:
        raise GrammarError(f"unknown plan verb {verb!r}")
    target = str(plan.get("target", ""))
    pools = {
        "scale": snapshot.statefulsets,
        "rollout_restart": snapshot.workloads,
        "cordon": snapshot.nodes,
        "delete_pod": snapshot.pods,
    }
    if verb != "noop":
        if target not in pools[verb]:
            raise GrammarError(
                f"plan target {target!r} not in the live snapshot")
    namespace, _, name = target.partition("/")
    if verb == "cordon":
        namespace, name = "", target
    out = {
        "verb": verb,
        "namespace": namespace,
        "name": name,
        "reason": str(plan.get("reason", "")),
    }
    if verb == "scale":
        replicas = int(plan["replicas"])
        if not 0 <= replicas <= MAX_REPLICAS:
            raise GrammarError(f"replicas {replicas} out of range")
        out["replicas"] = replicas
    return out


def render_plan(verb: str, *, target: str = "", reason: str = "",
                replicas: int | None = None) -> str:
    """Canonical plan serialization — the deterministic planner's path,
    mirroring ``grammar.render_verdict``: fields are filtered to the
    grammar's charset and clamped, so the output parses by construction
    (assuming the target is in the snapshot)."""
    def clean(s: str, max_len: int) -> str:
        out = "".join(
            ch for ch in s
            if 0x20 <= ord(ch) < 0x7F and ch not in ('"', "\\"))
        return out[:max_len] or "n/a"

    if verb not in PLAN_VERBS:
        raise GrammarError(f"unknown plan verb {verb!r}")
    parts = [f'"verb":"{verb}"']
    if verb != "noop":
        parts.append(f'"target":"{clean(target, 96)}"')
    if verb == "scale":
        r = min(max(int(replicas or 0), 0), MAX_REPLICAS)
        parts.append(f'"replicas":{r}')
    parts.append(f'"reason":"{clean(reason, REASON_MAX_CHARS)}"')
    return "{" + ",".join(parts) + "}"


def propose_plan(snapshot: TargetSnapshot, verdict: dict[str, Any],
                 trigger: str = "", context: str = "") -> str:
    """Deterministic scenario→verb planner (the template-backend path and
    the fallback when no constrained engine is wired).

    Keyword ladder over the verdict + trigger + context text, most
    specific first; a verb with no matching live target degrades to
    ``noop`` rather than guessing.
    """
    text = " ".join([
        trigger, str(verdict.get("component", "")),
        str(verdict.get("root_cause", "")),
        str(verdict.get("recommendation", "")), context,
    ]).lower()

    def find(pool: tuple[str, ...]) -> str:
        for ref in pool:
            name = ref.rsplit("/", 1)[-1]
            if name.lower() in text:
                return ref
        return ""

    if "failedscheduling" in text or "unschedulable pod" in text \
            or "stale scheduler" in text:
        target = find(snapshot.pods)
        if target:
            return render_plan("delete_pod", target=target,
                               reason=f"reschedule stale pod ({trigger})")
    if "pressure" in text or "notready" in text or "not ready" in text:
        target = find(snapshot.nodes)
        if target:
            return render_plan("cordon", target=target,
                               reason=f"fence pressured node ({trigger})")
    if "oom" in text or "crash" in text or "backoff" in text:
        target = find(snapshot.workloads)
        if target:
            return render_plan("rollout_restart", target=target,
                               reason=f"restart crashing workload ({trigger})")
    if ("queue" in text or "scale up" in text or "overload" in text) \
            and snapshot.statefulsets:
        target = find(snapshot.statefulsets) or snapshot.statefulsets[0]
        current = snapshot.statefulset_replicas.get(target, 1)
        return render_plan("scale", target=target,
                           replicas=min(current + 1, MAX_REPLICAS),
                           reason=f"add capacity ({trigger})")
    return render_plan("noop",
                       reason=f"no safe action for: {trigger or 'verdict'}")
