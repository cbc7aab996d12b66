"""SLO classes + the brownout ladder (docs/resilience.md).

Overload robustness is *class-ordered*, not first-come-first-shed: every
request carries an SLO class — ``interactive`` (a human is waiting),
``standard`` (API callers with retry budgets), ``batch`` (the standing
diagnosis pipeline, bulk analyses) — and the three pressure valves consult
the class before acting:

  * admission shedding sheds the lowest class first and never sheds a
    class while strictly-lower-priority work is still queued
    (``LLMEngine.should_shed``);
  * lane eviction preempts the lowest-class *running* lane when slots or
    KV pages run out (``LLMEngine._eviction_victim``);
  * the :class:`BrownoutController` ladder turns ``HealthMonitor`` state
    into staged degradation — hedging/speculation off and ``batch``
    max_tokens clamped at DEGRADED, diagnosis-pipeline triggers paused at
    DRAINING — with hysteretic (dwell-gated, one-step) recovery so a
    flapping health signal cannot oscillate the fleet.

Classes are host-side scheduling metadata only: no class value ever enters
a jitted program, so the plumbing is recompile-free by construction
(graftcheck's trace guards prove it).
"""

from __future__ import annotations

import time

from k8s_llm_monitor_tpu_torch.devtools.lockcheck import guarded_by, make_lock

# Priority order, highest first.  Rank is the shed/evict key: lower rank
# is protected, higher rank pays first.
SLO_CLASSES: tuple[str, ...] = ("interactive", "standard", "batch")
SLO_RANK: dict[str, int] = {c: i for i, c in enumerate(SLO_CLASSES)}
DEFAULT_CLASS = "standard"

# Brownout ladder levels (BrownoutController.level): monotone severity.
BROWNOUT_NORMAL = 0     # full service
BROWNOUT_DEGRADED = 1   # hedging + spec decode off, batch max_tokens clamped
BROWNOUT_DRAINING = 2   # + diagnosis-pipeline triggers paused
BROWNOUT_NAMES: tuple[str, ...] = ("normal", "degraded", "draining")


def normalize_slo_class(value, default: str = DEFAULT_CLASS) -> str:
    """Coerce an SLO class: empty/None → ``default``, unknown → ValueError.

    Callers at trust boundaries (HTTP handlers) catch the ValueError and
    map it to a 400; internal callers pass validated values through.
    """
    if value is None or value == "":
        return default
    cls = str(value).strip().lower()
    if cls not in SLO_RANK:
        raise ValueError(
            f"unknown slo_class {value!r}; expected one of {SLO_CLASSES}")
    return cls


def _level_for_state(state: str) -> int:
    """Raw health state → the ladder level it calls for."""
    if state in ("draining", "unhealthy"):
        return BROWNOUT_DRAINING
    if state == "degraded":
        return BROWNOUT_DEGRADED
    return BROWNOUT_NORMAL


@guarded_by("_lock", "_level", "_better_since", "escalations", "recoveries")
class BrownoutController:
    """Hysteretic degradation ladder over a health-state source.

    ``state_fn`` is read on every :meth:`level` call (``HealthMonitor``
    already computes state-on-read, so polling it is the idiom).
    Escalation is immediate — the moment health worsens, service degrades.
    De-escalation is deliberate: the raw signal must call for a *better*
    level continuously for ``recover_dwell_s`` before the ladder steps
    down, and it steps down one rung at a time — a DRAINING episode
    passes back through DEGRADED before full service resumes.  A single
    flap inside the dwell resets the timer, so an oscillating health
    signal pins the ladder at its worst recent level instead of toggling
    hedging/speculation on and off under load.
    """

    def __init__(self, state_fn, recover_dwell_s: float = 10.0,
                 clock=time.monotonic):
        self._state_fn = state_fn
        self.recover_dwell_s = recover_dwell_s
        self._clock = clock
        self._level = BROWNOUT_NORMAL
        # When the raw signal first became continuously better than the
        # held level; None while it is at or above the held level.
        self._better_since: float | None = None
        # Monotonic totals (exporter counters).
        self.escalations = 0
        self.recoveries = 0
        # Created last: lockcheck's guarded_by treats writes before the
        # lock exists as construction, not races.
        self._lock = make_lock("resilience.brownout")

    def level(self) -> int:
        """Current ladder level (0=normal, 1=degraded, 2=draining)."""
        raw = _level_for_state(self._state_fn())
        with self._lock:
            now = self._clock()
            if raw >= self._level:
                # At or above the held level: hold (or escalate) and reset
                # the recovery dwell.
                if raw > self._level:
                    self._level = raw
                    self.escalations += 1
                self._better_since = None
                return self._level
            if self._better_since is None:
                self._better_since = now
            elif now - self._better_since >= self.recover_dwell_s:
                self._level -= 1  # one rung per dwell, never straight home
                self.recoveries += 1
                self._better_since = None if raw >= self._level else now
            return self._level

    def name(self) -> str:
        return BROWNOUT_NAMES[self.level()]

    def snapshot(self) -> dict:
        lvl = self.level()
        with self._lock:
            return {
                "level": lvl,
                "name": BROWNOUT_NAMES[lvl],
                "escalations": self.escalations,
                "recoveries": self.recoveries,
                "recover_dwell_s": self.recover_dwell_s,
            }
