"""Live health state machine: HEALTHY → DEGRADED → DRAINING / UNHEALTHY.

Kubernetes probes (monitor/server.py ``/health`` and ``/readyz``) need
*truth*, not a hard-coded literal: a monitor whose engine sheds half its
admissions or trips the dispatch watchdog should stop receiving traffic
before it wedges.  The :class:`HealthMonitor` aggregates event streams from
the serving layer (watchdog trips, dispatch failures, sheds, admissions)
and computes the state on read:

  UNHEALTHY  — the step loop died, or ``unhealthy_failures`` consecutive
               dispatch failures (the engine is failing every dispatch);
  DRAINING   — drain mode armed (shutdown in progress): finish inflight,
               admit nothing — readiness is down, liveness still up;
  DEGRADED   — a watchdog trip or dispatch failure inside ``window_s``, or
               the recent shed rate crossed ``degraded_shed_rate``;
  HEALTHY    — none of the above for a full window.

Events carry timestamps from an injectable ``clock`` so chaos tests drive
transitions deterministically without sleeping.
"""

from __future__ import annotations

import collections
import time

from k8s_llm_monitor_tpu_torch.devtools.lockcheck import guarded_by, make_lock

HEALTHY = "healthy"
DEGRADED = "degraded"
DRAINING = "draining"
UNHEALTHY = "unhealthy"

# States a Kubernetes readiness probe should accept traffic in.
READY_STATES = (HEALTHY, DEGRADED)


@guarded_by("_lock", "_draining", "_dead_reason", "_consecutive_failures",
            "watchdog_trips", "dispatch_failures", "sheds", "admits")
class HealthMonitor:
    """Aggregates resilience events into the probe-facing health state."""

    def __init__(self, window_s: float = 30.0, degraded_shed_rate: float = 0.1,
                 unhealthy_failures: int = 8, clock=time.monotonic):
        self.window_s = window_s
        self.degraded_shed_rate = degraded_shed_rate
        self.unhealthy_failures = unhealthy_failures
        self._clock = clock
        self._draining = False
        self._dead_reason: str | None = None
        self._consecutive_failures = 0
        # Recent event timestamps, pruned to the window on read.
        self._trips: collections.deque[float] = collections.deque()
        self._failures: collections.deque[float] = collections.deque()
        self._sheds: collections.deque[float] = collections.deque()
        self._admits: collections.deque[float] = collections.deque()
        # Monotonic totals (exporter counters).
        self.watchdog_trips = 0
        self.dispatch_failures = 0
        self.sheds = 0
        self.admits = 0
        # Created last: lockcheck's guarded_by treats writes before the
        # lock exists as construction, not races.
        self._lock = make_lock("resilience.health")

    # -- event intake ---------------------------------------------------

    def record_watchdog_trip(self) -> None:
        with self._lock:
            self._trips.append(self._clock())
            self.watchdog_trips += 1

    def record_dispatch_failure(self) -> None:
        with self._lock:
            self._failures.append(self._clock())
            self.dispatch_failures += 1
            self._consecutive_failures += 1

    def record_dispatch_ok(self) -> None:
        with self._lock:
            self._consecutive_failures = 0

    def record_shed(self) -> None:
        with self._lock:
            self._sheds.append(self._clock())
            self.sheds += 1

    def record_admit(self) -> None:
        with self._lock:
            self._admits.append(self._clock())
            self.admits += 1

    def set_draining(self, draining: bool = True) -> None:
        with self._lock:
            self._draining = draining

    def set_dead(self, reason: str) -> None:
        """The step loop died; the state pins UNHEALTHY until restart."""
        with self._lock:
            self._dead_reason = reason

    def clear_dead(self) -> None:
        """The supervisor rebuilt the engine: un-pin UNHEALTHY so the
        replica can re-enter rotation (recent-window evidence still holds
        the state at DEGRADED until a clean window passes)."""
        with self._lock:
            self._dead_reason = None
            self._consecutive_failures = 0

    # -- state ----------------------------------------------------------

    def _prune(self, now: float) -> None:
        horizon = now - self.window_s
        for dq in (self._trips, self._failures, self._sheds, self._admits):
            while dq and dq[0] < horizon:
                dq.popleft()

    def state(self) -> str:
        return self.snapshot()["state"]

    def snapshot(self) -> dict:
        """State + the evidence behind it (the /health response body)."""
        with self._lock:
            now = self._clock()
            self._prune(now)
            recent_sheds = len(self._sheds)
            recent_admits = len(self._admits)
            offered = recent_sheds + recent_admits
            shed_rate = recent_sheds / offered if offered else 0.0
            reason = ""
            if self._dead_reason is not None:
                state = UNHEALTHY
                reason = self._dead_reason
            elif self._consecutive_failures >= self.unhealthy_failures:
                state = UNHEALTHY
                reason = (f"{self._consecutive_failures} consecutive "
                          f"dispatch failures")
            elif self._draining:
                state = DRAINING
                reason = "drain in progress"
            elif self._trips:
                state = DEGRADED
                reason = (f"{len(self._trips)} watchdog trip(s) in the last "
                          f"{self.window_s:.0f}s")
            elif self._failures:
                state = DEGRADED
                reason = (f"{len(self._failures)} dispatch failure(s) in "
                          f"the last {self.window_s:.0f}s")
            elif offered and shed_rate >= self.degraded_shed_rate:
                state = DEGRADED
                reason = (f"shedding {shed_rate:.0%} of admissions in the "
                          f"last {self.window_s:.0f}s")
            else:
                state = HEALTHY
            return {
                "state": state,
                "reason": reason,
                "ready": state in READY_STATES,
                "window_s": self.window_s,
                "recent": {
                    "watchdog_trips": len(self._trips),
                    "dispatch_failures": len(self._failures),
                    "sheds": recent_sheds,
                    "admits": recent_admits,
                    "shed_rate": round(shed_rate, 4),
                },
                "totals": {
                    "watchdog_trips": self.watchdog_trips,
                    "dispatch_failures": self.dispatch_failures,
                    "sheds": self.sheds,
                    "admits": self.admits,
                },
                "consecutive_dispatch_failures": self._consecutive_failures,
            }
