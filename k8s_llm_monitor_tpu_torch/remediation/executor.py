"""Closed-loop remediation: verdicts → gated execution → verified recovery.

``RemediationEngine`` is the plan stage the diagnosis pipeline calls after
publishing a verdict.  One pass through ``on_verdict``:

1. **Snapshot** live targets (``plans.TargetSnapshot``) — the plan
   grammar is compiled *from* this snapshot, so the model cannot name a
   resource that does not exist.
2. **Plan**: a grammar-constrained decode on the serving engine when the
   backend supports FSM swaps (``generate_with_grammar``), else the
   deterministic keyword planner (``plans.propose_plan``).  Either way the
   text goes through ``plans.parse_plan`` — the sanctioned parse — before
   anything else sees it.
3. **Execute** (only when ``RemediationConfig.execute`` is on, or a human
   approves the specific plan): idempotency-key replay guard, approval
   gate for destructive verbs (``K8SLLM_REMEDIATE_APPROVE=1`` or
   ``POST /api/v1/remediations/<id>/approve``), per-verb + per-target rate
   limits, per-verb circuit breaker, then dry-run-first through the
   cluster backend (server-side ``dryRun=All`` on the real client,
   simulated validation on the fake).
4. **Verify**: a follow-up diagnosis turn through the session machinery
   on freshly pinned post-action context, AND'd with a deterministic
   per-verb predicate over live state.  Unresolved records re-enter the
   pipeline as synthetic warnings with a capped escalation ladder.

The default posture is **observe-only** (``execute=False``): plans are
generated, stored, and exported, but nothing touches the cluster until an
operator flips the config or approves a specific plan.  Every action and
every refusal is a counted outcome (``remediation_plans_total``), a flight
-recorder note, and a tracer span — a remediator that silently does
nothing would be undiagnosable.
"""

from __future__ import annotations

import hashlib
import logging
import os
import time
from collections import deque
from typing import Any, Callable, Optional

from k8s_llm_monitor_tpu_torch.devtools.lockcheck import guarded_by, make_lock
from k8s_llm_monitor_tpu_torch.diagnosis.grammar import GrammarError, render_verdict
from k8s_llm_monitor_tpu_torch.observability.flight import get_flight_recorder
from k8s_llm_monitor_tpu_torch.observability.tracing import get_tracer
from k8s_llm_monitor_tpu_torch.remediation.plans import (
    DESTRUCTIVE_VERBS,
    PLAN_VERBS,
    TargetSnapshot,
    parse_plan,
    plan_fsm,
    propose_plan,
)
from k8s_llm_monitor_tpu_torch.resilience.retry import CircuitBreaker, CircuitOpen

logger = logging.getLogger("remediation.executor")

__all__ = ["RemediationEngine", "OUTCOMES", "VERIFY_RESULTS"]

#: Execution outcomes pre-seeded in the exporter (extra dynamic outcomes
#: still render; these are the contractual families).
OUTCOMES = ("proposed", "executed", "refused_approval", "refused_breaker",
            "refused_rate", "refused_replay", "error")

VERIFY_RESULTS = ("resolved", "unresolved", "error")

_VERDICT_PREAMBLE = (
    "You are a Kubernetes SRE assistant verifying a remediation action "
    "against live cluster evidence.\n"
)


def _env_approved() -> bool:
    """Blanket operator approval for destructive verbs.  Read per call —
    flipping the env var mid-process takes effect immediately, and tests
    toggle it with monkeypatch."""
    return os.environ.get("K8SLLM_REMEDIATE_APPROVE", "").lower() in (
        "1", "true", "yes")


@guarded_by("_lock", "plans_total", "verify_total", "_records", "_order",
            "_last_verb_t", "_last_target_t", "_executed", "_escalations")
class RemediationEngine:
    """Verdict → plan → gated execution → verification, with counters.

    All time comes from an injectable clock; gate proofs in
    ``tests/test_remediation.py`` drive it with a fake clock.  Thread
    safety matters because ``on_verdict`` runs on the pipeline worker
    while approve/reject arrive on HTTP threads.
    """

    def __init__(self, backend, analysis, cfg=None, *,
                 namespaces: tuple[str, ...] | list[str] = ("default",),
                 pipeline: Any = None,
                 clock: Callable[[], float] = time.monotonic) -> None:
        from k8s_llm_monitor_tpu_torch.monitor.config import RemediationConfig

        self.cfg = cfg or RemediationConfig()
        self.backend = backend
        self.analysis = analysis
        self.pipeline = pipeline
        self.namespaces = tuple(namespaces) or ("default",)
        self._clock = clock
        # One breaker per mutating verb: a broken scale path must not
        # stop an unrelated cordon.
        self.breakers: dict[str, CircuitBreaker] = {
            verb: CircuitBreaker(
                failure_threshold=self.cfg.breaker_failures,
                cooldown_s=self.cfg.breaker_cooldown_s,
                clock=clock)
            for verb in PLAN_VERBS if verb != "noop"
        }
        self._seq = 0
        # {(verb, outcome): count} → remediation_plans_total{verb,outcome}
        self.plans_total: dict[tuple[str, str], int] = {}
        # {result: count} → remediation_verify_total{result}
        self.verify_total: dict[str, int] = {}
        self._records: dict[str, dict] = {}
        self._order: deque[str] = deque(maxlen=max(8, self.cfg.history))
        self._last_verb_t: dict[str, float] = {}
        self._last_target_t: dict[tuple[str, str], float] = {}
        self._executed: dict[str, float] = {}  # idempotency key -> t
        self._escalations: dict[str, int] = {}
        # Created last (lockcheck construction rule).
        self._lock = make_lock("remediation.engine")

    # -- counting / recording --------------------------------------------

    def _count(self, verb: str, outcome: str) -> None:
        with self._lock:
            key = (verb, outcome)
            self.plans_total[key] = self.plans_total.get(key, 0) + 1

    def _note(self, rec: dict, outcome: str, detail: str = "") -> None:
        """Outcome bookkeeping shared by every gate: counter, record
        fields, flight-recorder note."""
        rec["outcome"] = outcome
        if detail:
            rec["detail"] = detail
        self._count(rec["plan"]["verb"], outcome)
        get_flight_recorder().note(
            "remediation", id=rec["id"], verb=rec["plan"]["verb"],
            target=rec["plan"].get("name", ""), outcome=outcome,
            detail=detail)

    def _store(self, rec: dict) -> None:
        with self._lock:
            if len(self._order) == self._order.maxlen:
                self._records.pop(self._order[0], None)
            self._records[rec["id"]] = rec
            self._order.append(rec["id"])

    # -- planning ---------------------------------------------------------

    def snapshot_targets(self) -> TargetSnapshot:
        return TargetSnapshot.from_backend(self.backend, self.namespaces)

    def _plan_prompt(self, snapshot: TargetSnapshot, verdict: dict,
                     trigger: str) -> str:
        lines = ["## Live targets"]
        lines += [f"- pod {p}" for p in snapshot.pods]
        lines += [f"- workload {w}" for w in snapshot.workloads]
        lines += [f"- node {n}" for n in snapshot.nodes]
        lines += [f"- statefulset {s}" for s in snapshot.statefulsets]
        return (
            "You are a Kubernetes SRE choosing ONE bounded remediation "
            "action against the live targets below.\n"
            + "\n".join(lines)
            + f"\n## Verdict\nseverity={verdict.get('severity')} "
            f"component={verdict.get('component')} "
            f"root_cause={verdict.get('root_cause')}\n"
            f"## Trigger\n{trigger}\n"
            "## Plan\nRespond with exactly one JSON action plan:\n"
        )

    def _plan_text(self, snapshot: TargetSnapshot, verdict: dict,
                   trigger: str, context: str) -> tuple[str, str]:
        """(plan text, planner name).  The constrained-engine path decodes
        under the snapshot's padded FSM; anything else — including an
        engine emitting an out-of-snapshot plan, which the FSM makes
        unreachable — falls back to the deterministic planner."""
        llm = getattr(self.analysis, "backend", None)
        if llm is not None and getattr(llm, "supports_grammar", False):
            try:
                text = llm.generate_with_grammar(
                    self._plan_prompt(snapshot, verdict, trigger),
                    plan_fsm(snapshot),
                    temperature=0.0, slo_class="batch")
                if text:
                    parse_plan(text, snapshot)  # raises if invalid
                    return text, "engine"
            except GrammarError as exc:
                logger.warning("engine plan rejected by grammar: %s", exc)
            except Exception:  # noqa: BLE001 — planner must degrade
                logger.exception("constrained plan decode failed")
        return propose_plan(snapshot, verdict, trigger, context), "heuristic"

    def on_verdict(self, verdict: dict, trigger: str = "",
                   context: str = "") -> Optional[dict]:
        """The pipeline's plan stage.  Returns the new record (or None
        when the verdict does not warrant one).  Never raises — a broken
        plan stage must not take the diagnosis worker down."""
        if not self.cfg.enabled:
            return None
        if verdict.get("severity") not in ("warning", "critical"):
            return None
        tracer = get_tracer()
        try:
            with tracer.span("remediation.plan",
                             attrs={"trigger": trigger[:120]}):
                snapshot = self.snapshot_targets()
                text, planner = self._plan_text(
                    snapshot, verdict, trigger, context)
                plan = parse_plan(text, snapshot)
        except GrammarError as exc:
            logger.warning("plan stage produced no valid plan: %s", exc)
            self._count("noop", "error")
            return None
        except Exception:  # noqa: BLE001 — plan stage is best-effort
            logger.exception("plan stage failed")
            self._count("noop", "error")
            return None
        with self._lock:
            self._seq += 1
            rec_id = f"rem-{self._seq:05d}"
        target_ref = (f"{plan['namespace']}/{plan['name']}"
                      if plan["namespace"] else plan["name"])
        rec = {
            "id": rec_id,
            "t_mono": round(self._clock(), 3),
            "plan": plan,
            "text": text,
            "planner": planner,
            "verdict": dict(verdict),
            "trigger": trigger,
            "status": "proposed",
            "outcome": "",
            "detail": "",
            "approved": False,
            "escalation": self._escalations.get(
                self._esc_key(plan), 0),
            "idempotency_key": self._idem_key(plan, trigger),
            "verify": None,
        }
        self._store(rec)
        self._note(rec, "proposed", f"planner={planner} target={target_ref}")
        if self.cfg.execute:
            self.execute(rec_id)
        return rec

    # -- gating / execution ----------------------------------------------

    @staticmethod
    def _idem_key(plan: dict, trigger: str) -> str:
        raw = "|".join([plan["verb"], plan["namespace"], plan["name"],
                        str(plan.get("replicas", "")), trigger])
        return hashlib.sha256(raw.encode()).hexdigest()[:16]

    @staticmethod
    def _esc_key(plan: dict) -> str:
        return f"{plan['verb']}|{plan['namespace']}/{plan['name']}"

    def _apply(self, plan: dict, dry_run: bool) -> None:
        verb = plan["verb"]
        if verb == "noop":
            return
        if verb == "scale":
            self.backend.scale_statefulset(
                plan["namespace"], plan["name"], plan["replicas"],
                dry_run=dry_run)
        elif verb == "rollout_restart":
            self.backend.rollout_restart(
                plan["namespace"], plan["name"], dry_run=dry_run)
        elif verb == "cordon":
            self.backend.cordon_node(plan["name"], dry_run=dry_run)
        elif verb == "delete_pod":
            self.backend.delete_pod(
                plan["namespace"], plan["name"], dry_run=dry_run)

    def _refusal(self, rec: dict, now: float) -> Optional[tuple[str, str]]:
        """The gate ladder; returns (outcome, detail) or None when every
        gate is open.  Order: replay guard (an already-done action makes
        every other question moot), approval, rate limits, breaker."""
        plan = rec["plan"]
        verb = plan["verb"]
        with self._lock:
            done_t = self._executed.get(rec["idempotency_key"])
        if done_t is not None and now - done_t < self.cfg.replay_window_s:
            return ("refused_replay",
                    f"identical action executed {now - done_t:.1f}s ago")
        if verb in DESTRUCTIVE_VERBS and not rec["approved"] \
                and not _env_approved():
            return ("refused_approval",
                    "destructive verb requires K8SLLM_REMEDIATE_APPROVE=1 "
                    "or POST .../approve")
        if verb == "noop":
            return None  # nothing below applies to a no-op
        with self._lock:
            last_v = self._last_verb_t.get(verb)
            last_t = self._last_target_t.get((verb, plan["name"]))
        if last_v is not None and now - last_v < self.cfg.verb_interval_s:
            return ("refused_rate", f"verb {verb} on cooldown")
        if last_t is not None and now - last_t < self.cfg.target_interval_s:
            return ("refused_rate",
                    f"target {plan['name']} on cooldown for {verb}")
        try:
            self.breakers[verb].before_call()
        except CircuitOpen as exc:
            return ("refused_breaker", str(exc))
        return None

    def execute(self, rec_id: str) -> str:
        """Run one stored plan through the full gate ladder.  Returns the
        outcome string; the record's status/outcome fields are updated in
        place."""
        with self._lock:
            rec = self._records.get(rec_id)
        if rec is None:
            return "not_found"
        if rec["status"] in ("executed", "verified", "rejected"):
            self._note(rec, "refused_replay",
                       f"record already {rec['status']}")
            return "refused_replay"
        plan = rec["plan"]
        verb = plan["verb"]
        now = self._clock()
        refusal = self._refusal(rec, now)
        if refusal is not None:
            outcome, detail = refusal
            if outcome == "refused_approval":
                rec["status"] = "awaiting_approval"
            self._note(rec, outcome, detail)
            return outcome
        tracer = get_tracer()
        breaker = self.breakers.get(verb)
        t0 = time.monotonic()
        try:
            with tracer.span("remediation.execute",
                             attrs={"verb": verb, "target": plan["name"]}):
                if self.cfg.dry_run_first:
                    self._apply(plan, dry_run=True)
                self._apply(plan, dry_run=False)
        except Exception as exc:  # noqa: BLE001 — cluster fault
            if breaker is not None:
                breaker.record_failure()
            rec["status"] = "error"
            self._note(rec, "error", f"{type(exc).__name__}: {exc}")
            logger.warning("remediation %s %s failed: %s",
                           verb, plan["name"], exc)
            return "error"
        if breaker is not None:
            breaker.record_success()
        with self._lock:
            self._last_verb_t[verb] = now
            self._last_target_t[(verb, plan["name"])] = now
            self._executed[rec["idempotency_key"]] = now
        rec["status"] = "executed"
        rec["execute_ms"] = round((time.monotonic() - t0) * 1e3, 3)
        self._note(rec, "executed", "dry-run validated"
                   if self.cfg.dry_run_first else "")
        if self.cfg.verify:
            self.verify(rec_id)
        return "executed"

    # -- approval (the human-in-the-loop path) ----------------------------

    def approve(self, rec_id: str) -> Optional[dict]:
        """Explicit per-plan approval.  Approving executes immediately,
        even in observe-only mode — this IS the operator saying "do it"."""
        with self._lock:
            rec = self._records.get(rec_id)
        if rec is None:
            return None
        rec["approved"] = True
        self.execute(rec_id)
        return rec

    def reject(self, rec_id: str) -> Optional[dict]:
        with self._lock:
            rec = self._records.get(rec_id)
        if rec is None:
            return None
        if rec["status"] in ("proposed", "awaiting_approval"):
            rec["status"] = "rejected"
            self._note(rec, "rejected", "operator rejection")
        return rec

    # -- verification ------------------------------------------------------

    def _cluster_context(self) -> str:
        """Post-action evidence block: live pods/nodes/statefulsets in the
        ``- `` line shape every backend's issue extractor understands.
        Deliberately NOT the pipeline's event ring — old warnings from the
        incident would poison a health check of the *current* state."""
        lines = ["## Cluster state (post-action)"]
        for ns in self.namespaces:
            try:
                pods = self.backend.list_pods(ns)
            except Exception:  # noqa: BLE001 — partial evidence is fine
                continue
            for pod in pods:
                meta = pod.get("metadata") or {}
                status = pod.get("status") or {}
                restarts = sum(
                    int(s.get("restartCount", 0))
                    for s in status.get("containerStatuses", []))
                lines.append(
                    f"- pod {ns}/{meta.get('name', '?')} "
                    f"phase={status.get('phase', '?')} restarts={restarts}")
        try:
            nodes = self.backend.list_nodes()
        except Exception:  # noqa: BLE001
            nodes = []
        for node in nodes:
            meta = node.get("metadata") or {}
            spec = node.get("spec") or {}
            conds = {c.get("type"): c.get("status")
                     for c in (node.get("status") or {}).get("conditions", [])}
            lines.append(
                f"- node {meta.get('name', '?')} "
                f"ready={conds.get('Ready', '?')} "
                f"unschedulable={bool(spec.get('unschedulable'))}")
        return "\n".join(lines) + "\n"

    def _condition_cleared(self, plan: dict) -> bool:
        """Deterministic per-verb recovery predicate over live state — the
        half of verification that cannot hallucinate."""
        verb, ns, name = plan["verb"], plan["namespace"], plan["name"]
        if verb == "noop":
            return True
        if verb == "scale":
            scale = self.backend.get_statefulset_scale(ns, name)
            observed = scale if isinstance(scale, int) else int(
                (scale.get("spec") or {}).get("replicas", -1))
            return observed == plan["replicas"]
        if verb == "delete_pod":
            pods = self.backend.list_pods(ns)
            return all((p.get("metadata") or {}).get("name") != name
                       for p in pods)
        if verb == "cordon":
            for node in self.backend.list_nodes():
                if (node.get("metadata") or {}).get("name") == name:
                    return bool((node.get("spec") or {}).get("unschedulable"))
            return False
        if verb == "rollout_restart":
            matched = [
                p for p in self.backend.list_pods(ns)
                if ((p.get("metadata") or {}).get("name") or ""
                    ).startswith(name)
            ]
            if not matched:
                return False
            for pod in matched:
                status = pod.get("status") or {}
                if status.get("phase") != "Running":
                    return False
                for s in status.get("containerStatuses", []):
                    if int(s.get("restartCount", 0)) > 0:
                        return False
            return True
        return False

    def verify(self, rec_id: str) -> str:
        """Post-action verification turn.  Result ∈ VERIFY_RESULTS; the
        record moves to ``verified`` / ``unresolved`` / ``escalated``."""
        with self._lock:
            rec = self._records.get(rec_id)
        if rec is None:
            return "error"
        plan = rec["plan"]
        tracer = get_tracer()
        try:
            with tracer.span("remediation.verify",
                             attrs={"verb": plan["verb"]}):
                cleared = self._condition_cleared(plan)
                verdict = self._verify_verdict(rec)
                resolved = cleared and verdict.get("severity") != "critical"
        except Exception as exc:  # noqa: BLE001 — verification fault
            with self._lock:
                self.verify_total["error"] = \
                    self.verify_total.get("error", 0) + 1
            rec["verify"] = {"result": "error", "detail": str(exc)}
            logger.exception("remediation verify failed")
            return "error"
        result = "resolved" if resolved else "unresolved"
        with self._lock:
            self.verify_total[result] = self.verify_total.get(result, 0) + 1
        rec["verify"] = {
            "result": result,
            "condition_cleared": cleared,
            "verdict": verdict,
        }
        get_flight_recorder().note(
            "remediation_verify", id=rec["id"], verb=plan["verb"],
            result=result)
        if resolved:
            rec["status"] = "verified"
            return result
        self._escalate(rec)
        return result

    def _verify_verdict(self, rec: dict) -> dict:
        """The LLM half of verification: a constrained diagnosis turn on a
        session pinned to freshly collected post-action context, so retry
        turns replay a cached prefix instead of re-prefilling."""
        plan = rec["plan"]
        question = (
            f"Remediation {plan['verb']} on "
            f"{plan['namespace'] + '/' if plan['namespace'] else ''}"
            f"{plan['name'] or 'cluster'} was executed for: "
            f"{rec['trigger'] or 'a diagnosis verdict'}. "
            "Is the triggering condition cleared?")
        sessions = getattr(self.analysis, "sessions", None)
        context = None
        if sessions is not None:
            session, _ = sessions.get_or_create(
                f"remediation-{rec['id']}",
                lambda: _VERDICT_PREAMBLE + self._cluster_context())
            context = session.context
        verdict = self.analysis.diagnose(
            question, context=context, slo_class="batch")
        if sessions is not None:
            session.record(question, render_verdict(
                verdict["severity"], verdict["component"],
                verdict["root_cause"], verdict["recommendation"],
                verdict["confidence"]))
        return verdict

    def _escalate(self, rec: dict) -> None:
        """Capped retry ladder: an unresolved record re-enters the
        pipeline as a synthetic warning (so the next burst re-plans with
        fresh state); past the cap it parks as ``escalated`` for a
        human."""
        key = self._esc_key(rec["plan"])
        with self._lock:
            n = self._escalations.get(key, 0) + 1
            self._escalations[key] = n
        rec["escalation"] = n
        if n > self.cfg.max_retries:
            rec["status"] = "escalated"
            logger.warning("remediation escalated after %d attempts: %s",
                           n, key)
            return
        rec["status"] = "unresolved"
        if self.pipeline is None:
            return
        from k8s_llm_monitor_tpu_torch.monitor.models import EventInfo

        event = EventInfo(
            type="Warning",
            reason=f"RemediationUnresolved:{rec['plan']['verb']}",
            message=(f"plan {rec['id']} ({rec['plan']['verb']} "
                     f"{rec['plan']['name']}) did not clear: "
                     f"{rec['trigger']} (attempt {n})"),
            source="remediation",
        )
        try:
            self.pipeline.offer(event)
        except Exception:  # noqa: BLE001 — re-entry is best-effort
            logger.exception("remediation re-entry offer failed")

    # -- observability -----------------------------------------------------

    def records(self, limit: int = 0) -> list[dict]:
        """Newest-first JSON-safe record list for the HTTP API."""
        with self._lock:
            ids = list(self._order)
            out = [dict(self._records[i]) for i in reversed(ids)
                   if i in self._records]
        return out[:limit] if limit > 0 else out

    def get(self, rec_id: str) -> Optional[dict]:
        with self._lock:
            rec = self._records.get(rec_id)
            return dict(rec) if rec is not None else None

    def counters(self) -> dict:
        with self._lock:
            return {
                "plans_total": dict(self.plans_total),
                "verify_total": dict(self.verify_total),
                "breaker_open": {
                    verb: 1 if br.state == "open" else 0
                    for verb, br in sorted(self.breakers.items())},
            }

    def snapshot(self) -> dict:
        """JSON-safe block for /api/v1/stats."""
        with self._lock:
            plans = {f"{verb}/{outcome}": n
                     for (verb, outcome), n
                     in sorted(self.plans_total.items())}
            verify = dict(self.verify_total)
            n_records = len(self._records)
        return {
            "enabled": bool(self.cfg.enabled),
            "execute": bool(self.cfg.execute),
            "records": n_records,
            "plans_total": plans,
            "verify_total": verify,
            "breakers": {verb: br.state
                         for verb, br in sorted(self.breakers.items())},
        }
