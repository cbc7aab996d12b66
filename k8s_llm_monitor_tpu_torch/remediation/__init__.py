"""Closed-loop remediation: grammar-bounded action plans, gated execution,
verified recovery.

Two modules:

- ``plans`` — the action-plan grammar.  Verbs are a closed set
  (``scale``/``rollout_restart``/``cordon``/``delete_pod``/``noop``) and
  every target is enumerated from a live-state ``TargetSnapshot``, so the
  compiled token FSM structurally cannot name a nonexistent resource.
- ``executor`` — ``RemediationEngine``: dry-run-first execution behind
  per-verb circuit breakers, rate limits, an approval gate for destructive
  verbs, idempotent replay protection, and a post-action verification turn
  through the diagnosis session machinery.

See ``docs/remediation.md`` for the verb catalog and operational posture
(observe-only by default).
"""

from k8s_llm_monitor_tpu_torch.remediation.executor import (
    OUTCOMES,
    VERIFY_RESULTS,
    RemediationEngine,
)
from k8s_llm_monitor_tpu_torch.remediation.plans import (
    DESTRUCTIVE_VERBS,
    PLAN_STATE_CAP,
    PLAN_VERBS,
    TargetSnapshot,
    build_plan_schema,
    parse_plan,
    plan_dfa,
    plan_fsm,
    propose_plan,
    render_plan,
)

__all__ = [
    "RemediationEngine",
    "OUTCOMES",
    "VERIFY_RESULTS",
    "PLAN_VERBS",
    "DESTRUCTIVE_VERBS",
    "PLAN_STATE_CAP",
    "TargetSnapshot",
    "build_plan_schema",
    "plan_dfa",
    "plan_fsm",
    "parse_plan",
    "render_plan",
    "propose_plan",
]
