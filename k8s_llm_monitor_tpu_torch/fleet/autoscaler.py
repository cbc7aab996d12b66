"""Elasticity controller: close the telemetry plane's sense→decide→act loop.

``AutoscaleController`` consumes the ``SignalScraper``'s per-target
``scale_hint``s (plus the ``queue_growth`` / ``ttft_breach`` anomaly
flags), folds them into one desired direction per fleet *role*
(prefill / decode / unified — each target's role comes from the registry's
probe rows), and executes scale decisions through a pluggable executor:

* ``KubeScaleExecutor`` — per-role StatefulSet ``/scale`` subresources
  through the hardened kube client (retry budget + breaker, PR 2
  semantics), dry-run-first so a malformed patch never hits the fleet.
* ``LocalPoolExecutor`` — an in-process ``LocalReplica`` pool for tests,
  bench, and the single-binary dev mode: scale-up spawns a replica via a
  factory and registers it; scale-down *drains* the newest replica of the
  role (the router stops dispatching to it, in-flight streams finish) and
  ``reap()`` removes it once idle.  The whole loop is chaos-testable
  without a cluster.

Hysteresis — the controller's entire job is to NOT act most of the time:

* **cooldown** after any executed action (no thrash on its own wake),
* **dwell-gated scale-down**: hints must agree "down" continuously for
  ``scale_down_dwell_s`` before a replica is removed (scale-up stays
  fast — under-capacity hurts users, over-capacity hurts the bill),
* **min/max replicas per role** (a runaway signal can never scale to
  zero or to infinity),
* **flap damping**: more than ``flap_max_flips`` desire-direction changes
  inside ``flap_window_s`` freezes the role until hints settle,
* a **per-verb circuit breaker** around the executor: a broken API
  server opens the breaker and the controller refuses (counted) instead
  of hammering.

Every action AND every refusal lands in
``autoscale_actions_total{role,direction,outcome}`` and — when a
diagnosis pipeline is wired — as a synthetic ``source="autoscaler"``
event, so the monitor can diagnose its own elasticity decisions.

All time comes from an injectable clock; tests drive ``tick()`` with a
fake clock.
"""

from __future__ import annotations

import itertools
import logging
import threading
import time
from collections import deque
from typing import Any, Callable, Optional

from k8s_llm_monitor_tpu_torch.devtools.lockcheck import guarded_by, make_lock
from k8s_llm_monitor_tpu_torch.resilience.retry import (CircuitBreaker,
                                                       CircuitOpen)

logger = logging.getLogger("fleet.autoscaler")

__all__ = ["AutoscaleController", "KubeScaleExecutor", "LocalPoolExecutor"]

ROLES = ("prefill", "decode", "unified")

# Anomaly flags that read as "scale up now" regardless of the folded hint.
_UP_FLAGS = ("queue_growth", "ttft_breach")


class KubeScaleExecutor:
    """Scale per-role StatefulSets through the hardened kube backend.

    The backend (``monitor/kube_rest.py``) already owns retries, backoff,
    fault injection, and its own cluster breaker; this adapter only maps
    role → StatefulSet name and role → scale verb."""

    def __init__(self, backend, cfg) -> None:
        self.backend = backend
        self.cfg = cfg

    def _name(self, role: str) -> str:
        return {
            "prefill": self.cfg.statefulset_prefill,
            "decode": self.cfg.statefulset_decode,
        }.get(role, self.cfg.statefulset_unified)

    def current_replicas(self, role: str) -> int:
        scale = self.backend.get_statefulset_scale(
            self.cfg.namespace, self._name(role))
        spec = scale.get("spec") or {}
        return int(spec.get("replicas", 0))

    def scale(self, role: str, replicas: int, dry_run: bool = False) -> None:
        self.backend.scale_statefulset(
            self.cfg.namespace, self._name(role), replicas, dry_run=dry_run)

    def reap(self) -> list[str]:
        return []  # kube terminates drained pods itself (preStop + grace)


class LocalPoolExecutor:
    """In-process replica pool behind the executor interface.

    ``factory(role, replica_id)`` builds a ready-to-serve replica
    (typically a ``LocalReplica`` over a fresh ``EngineService``); the
    executor registers it with the fleet registry and probes it once so
    the router can dispatch immediately.  Scale-down drains the newest
    replica of the role — removal happens later in ``reap()``, once the
    router-side inflight count hits zero, so no stream is cut."""

    def __init__(self, registry, factory: Callable[[str, str], Any]) -> None:
        self.registry = registry
        self.factory = factory
        self._seq = itertools.count()
        self._pools: dict[str, list] = {r: [] for r in ROLES}
        self._lock = make_lock("fleet.autoscaler.localpool")

    def adopt(self, role: str, replica) -> None:
        """Track a replica that was built outside the executor (the
        initial fleet) so current_replicas()/scale() see it."""
        with self._lock:
            self._pools.setdefault(role, []).append(replica)

    def _live(self, role: str) -> list:
        with self._lock:
            pool = list(self._pools.get(role, ()))
        return [r for r in pool if not getattr(r, "draining", False)]

    def current_replicas(self, role: str) -> int:
        return len(self._live(role))

    def scale(self, role: str, replicas: int, dry_run: bool = False) -> None:
        live = self._live(role)
        want = max(0, int(replicas))
        if dry_run:
            if want > len(live) and self.factory is None:
                raise RuntimeError("no replica factory for scale-up")
            return
        while len(live) < want:
            rid = f"{role}-auto-{next(self._seq)}"
            replica = self.factory(role, rid)
            with self._lock:
                self._pools.setdefault(role, []).append(replica)
            self.registry.add(replica)
            self.registry.refresh(rid)
            logger.info("local pool: spawned %s", rid)
            live.append(replica)
        while len(live) > want:
            victim = live.pop()  # newest first: oldest keep their caches
            drain = getattr(victim, "drain", None)
            if callable(drain):
                drain()
                # Probe now so the draining flag is visible to the router
                # (and the drain sweep fires) before the next cycle.
                self.registry.refresh(victim.replica_id)
                logger.info("local pool: draining %s", victim.replica_id)
            else:
                self.registry.remove(victim.replica_id)
                victim.close()

    def reap(self) -> list[str]:
        """Remove drained replicas whose router-side inflight hit zero.
        Returns the removed replica ids."""
        removed: list[str] = []
        with self._lock:
            draining = [(role, r) for role, pool in self._pools.items()
                        for r in pool if getattr(r, "draining", False)]
        for role, replica in draining:
            rid = replica.replica_id
            entry = self.registry.get(rid)
            if entry is not None and entry.inflight > 0:
                continue  # streams still finishing: not yet
            self.registry.remove(rid)
            with self._lock:
                pool = self._pools.get(role, [])
                if replica in pool:
                    pool.remove(replica)
            try:
                replica.close()
            except Exception:  # noqa: BLE001 — teardown is best-effort
                logger.exception("closing drained replica %s failed", rid)
            removed.append(rid)
            logger.info("local pool: reaped drained %s", rid)
        return removed


@guarded_by("_lock", "actions_total", "_last_action_t", "_down_since",
            "_flips", "_last_desire")
class AutoscaleController:
    """Sense (signals) → decide (hysteresis gates) → act (executor).

    ``tick()`` is the synchronous seam tests drive with a fake clock;
    ``start()`` runs it on a daemon thread every ``cfg.interval_s``.
    The controller acts only when every gate agrees — the acceptance
    criterion is literally "never acts while dwell/cooldown gates are
    closed or the breaker is open"."""

    def __init__(self, signals, executor, cfg=None, *,
                 registry=None, pipeline: Any = None,
                 clock: Callable[[], float] = time.monotonic) -> None:
        from k8s_llm_monitor_tpu_torch.monitor.config import AutoscaleConfig

        self.cfg = cfg or AutoscaleConfig()
        self.signals = signals
        self.executor = executor
        self.registry = registry
        self.pipeline = pipeline
        self._clock = clock
        self.breaker = CircuitBreaker(
            failure_threshold=self.cfg.breaker_failures,
            cooldown_s=self.cfg.breaker_cooldown_s)
        # {(role, direction, outcome): count} — the exporter renders this
        # as autoscale_actions_total{role,direction,outcome}.
        self.actions_total: dict[tuple[str, str, str], int] = {}
        self.events: deque[dict] = deque(maxlen=64)
        self._last_action_t: Optional[float] = None
        self._down_since: dict[str, float] = {}
        self._flips: dict[str, deque] = {}
        self._last_desire: dict[str, str] = {}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # Created last (lockcheck construction rule).
        self._lock = make_lock("fleet.autoscaler")

    # -- lifecycle -------------------------------------------------------

    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()

        def _loop() -> None:
            while not self._stop.wait(timeout=self.cfg.interval_s):
                try:
                    self.tick()
                except Exception:  # noqa: BLE001 — loop must survive
                    logger.exception("autoscale tick failed")

        self._thread = threading.Thread(
            target=_loop, name="fleet-autoscaler", daemon=True)
        self._thread.start()

    def stop(self, timeout: float = 5.0) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=timeout)
            self._thread = None

    # -- sensing ---------------------------------------------------------

    def _role_of(self, target: str) -> str:
        if self.registry is not None:
            entry = self.registry.get(target)
            if entry is not None:
                role = entry.stats.role
                return role if role in ROLES else "unified"
        return "unified"

    def desired_directions(self) -> dict[str, str]:
        """Fold per-target hints/anomalies into one direction per role.
        Any target screaming "up" (hint or anomaly) wins for its role;
        "down" requires EVERY fresh target of the role to agree; stale
        targets are no evidence in either direction."""
        body = self.signals.signals()
        targets = body.get("targets") or {}
        votes: dict[str, list[str]] = {}
        for target, derived in targets.items():
            role = self._role_of(target)
            if derived.get("stale"):
                votes.setdefault(role, []).append("steady")
                continue
            hint = derived.get("scale_hint", "steady")
            if hint != "up" and any(f in _UP_FLAGS
                                    for f in derived.get("anomalies", ())):
                hint = "up"
            votes.setdefault(role, []).append(hint)
        out = {}
        for role, hints in votes.items():
            if "up" in hints:
                out[role] = "up"
            elif hints and all(h == "down" for h in hints):
                out[role] = "down"
            else:
                out[role] = "steady"
        return out

    # -- deciding --------------------------------------------------------

    def _bounds(self, role: str) -> tuple[int, int]:
        return {
            "prefill": (self.cfg.min_prefill, self.cfg.max_prefill),
            "decode": (self.cfg.min_decode, self.cfg.max_decode),
        }.get(role, (self.cfg.min_unified, self.cfg.max_unified))

    def _note(self, role: str, direction: str, outcome: str,
              detail: str = "") -> None:
        """Count + remember + (optionally) feed the diagnosis pipeline.
        Refusals are first-class outcomes: a controller that silently
        does nothing is undiagnosable."""
        now = self._clock()
        key = (role, direction, outcome)
        with self._lock:
            self.actions_total[key] = self.actions_total.get(key, 0) + 1
            self.events.append({
                "t_mono": round(now, 3), "role": role,
                "direction": direction, "outcome": outcome,
                "detail": detail,
            })
        if self.pipeline is None:
            return
        from k8s_llm_monitor_tpu_torch.monitor.models import EventInfo

        event = EventInfo(
            type="Normal" if outcome == "applied" else "Warning",
            reason=f"Autoscale:{direction}:{outcome}",
            message=f"role {role}: {direction} -> {outcome}"
                    + (f" ({detail})" if detail else ""),
            source="autoscaler",
        )
        try:
            self.pipeline.offer(event)
        except Exception:  # noqa: BLE001 — feed is best-effort
            logger.exception("autoscaler event injection failed")

    def _flap_count(self, role: str, now: float) -> int:
        with self._lock:
            ring = self._flips.get(role)
            if ring is None:
                return 0
            while ring and now - ring[0] > self.cfg.flap_window_s:
                ring.popleft()
            return len(ring)

    def _track_desire(self, role: str, desire: str, now: float) -> None:
        with self._lock:
            prev = self._last_desire.get(role)
            if (prev is not None and desire != prev
                    and "steady" not in (prev, desire)):
                self._flips.setdefault(role, deque()).append(now)
            self._last_desire[role] = desire

    def _cooldown_left(self, now: float) -> float:
        with self._lock:
            last = self._last_action_t
        if last is None:
            return 0.0
        return max(0.0, self.cfg.cooldown_s - (now - last))

    # -- acting ----------------------------------------------------------

    def _execute(self, role: str, target: int, direction: str) -> str:
        """One gated executor call: breaker slot, dry-run first, then the
        real scale.  Returns the outcome string."""
        try:
            self.breaker.before_call()
        except CircuitOpen:
            return "refused_breaker"
        try:
            if self.cfg.dry_run_first:
                self.executor.scale(role, target, dry_run=True)
            self.executor.scale(role, target, dry_run=False)
        except Exception as exc:  # noqa: BLE001 — executor fault
            self.breaker.record_failure()
            logger.warning("scale %s -> %d failed: %s", role, target, exc)
            return "error"
        self.breaker.record_success()
        return "applied"

    def tick(self) -> list[dict]:
        """One decision cycle.  Returns the events recorded this cycle
        (actions and refusals both)."""
        now = self._clock()
        before = len(self.events)
        reap = getattr(self.executor, "reap", None)
        if callable(reap):
            reap()
        desires = self.desired_directions()
        # Opposing desires are a rebalance opportunity: move capacity
        # between roles instead of growing the fleet.
        ups = [r for r, d in desires.items() if d == "up"]
        downs = [r for r, d in desires.items() if d == "down"]
        for role, desire in sorted(desires.items()):
            self._track_desire(role, desire, now)
        if ups and downs:
            self.rebalance(downs[0], ups[0], now=now)
        else:
            for role, desire in sorted(desires.items()):
                if desire == "steady":
                    with self._lock:
                        self._down_since.pop(role, None)
                    continue
                self._step(role, desire, now)
        with self._lock:
            return list(self.events)[before:]

    def _gates(self, role: str, direction: str, now: float,
               dwell_gated: bool = True) -> Optional[str]:
        """Shared refusal ladder; returns the refusal outcome or None when
        every gate is open.  Order matters: the breaker is checked first
        (an unusable executor makes every other question moot), then
        cooldown, then the down-dwell, then flap damping."""
        if self.breaker.state == "open":
            return "refused_breaker"
        if self._cooldown_left(now) > 0.0:
            return "refused_cooldown"
        if direction == "down" and dwell_gated:
            with self._lock:
                since = self._down_since.setdefault(role, now)
            if now - since < self.cfg.scale_down_dwell_s:
                return "refused_dwell"
        if self._flap_count(role, now) > self.cfg.flap_max_flips:
            return "refused_flap"
        return None

    def _step(self, role: str, direction: str, now: float) -> None:
        refusal = self._gates(role, direction, now)
        if refusal is not None:
            self._note(role, direction, refusal)
            return
        try:
            current = int(self.executor.current_replicas(role))
        except Exception as exc:  # noqa: BLE001 — executor fault
            self.breaker.record_failure()
            self._note(role, direction, "error", f"read: {exc}")
            return
        lo, hi = self._bounds(role)
        target = min(hi, current + 1) if direction == "up" \
            else max(lo, current - 1)
        if target == current:
            self._note(role, direction, "refused_minmax",
                       f"at bound {current} in [{lo},{hi}]")
            return
        outcome = self._execute(role, target, direction)
        self._note(role, direction, outcome, f"{current}->{target}")
        if outcome == "applied":
            with self._lock:
                self._last_action_t = now
                self._down_since.pop(role, None)
            logger.info("autoscale %s: %s %d -> %d",
                        direction, role, current, target)

    def rebalance(self, from_role: str, to_role: str,
                  now: Optional[float] = None) -> bool:
        """Move one replica of capacity between roles (scale ``from_role``
        down and ``to_role`` up) under the same gates as a plain action;
        the scale-down half keeps its dwell gate — a rebalance must not
        be a back door around the down hysteresis.  Returns True when
        both halves applied."""
        now = self._clock() if now is None else now
        refusal = self._gates(from_role, "down", now) \
            or self._gates(to_role, "up", now)
        if refusal is not None:
            self._note(to_role, "rebalance", refusal,
                       f"{from_role}->{to_role}")
            return False
        try:
            cur_from = int(self.executor.current_replicas(from_role))
            cur_to = int(self.executor.current_replicas(to_role))
        except Exception as exc:  # noqa: BLE001 — executor fault
            self.breaker.record_failure()
            self._note(to_role, "rebalance", "error", f"read: {exc}")
            return False
        lo_f, _ = self._bounds(from_role)
        _, hi_t = self._bounds(to_role)
        if cur_from - 1 < lo_f or cur_to + 1 > hi_t:
            self._note(to_role, "rebalance", "refused_minmax",
                       f"{from_role}@{cur_from} -> {to_role}@{cur_to}")
            return False
        out_up = self._execute(to_role, cur_to + 1, "up")
        if out_up != "applied":
            self._note(to_role, "rebalance", out_up)
            return False
        out_down = self._execute(from_role, cur_from - 1, "down")
        self._note(from_role, "rebalance", out_down,
                   f"{from_role} {cur_from}->{cur_from - 1}")
        self._note(to_role, "rebalance", "applied",
                   f"{to_role} {cur_to}->{cur_to + 1}")
        with self._lock:
            self._last_action_t = now
            self._down_since.pop(from_role, None)
        logger.info("autoscale rebalance: %s -> %s", from_role, to_role)
        return out_down == "applied"

    # -- observability ---------------------------------------------------

    def counters(self) -> dict:
        with self._lock:
            return {
                "actions_total": dict(self.actions_total),
                "recent": list(self.events),
            }

    def snapshot(self) -> dict:
        """JSON-safe block for /api/v1/stats on the router role."""
        with self._lock:
            actions = {
                f"{role}/{direction}/{outcome}": n
                for (role, direction, outcome), n
                in sorted(self.actions_total.items())}
            recent = list(self.events)[-8:]
            last = self._last_action_t
        return {
            "enabled": bool(self.cfg.enabled),
            "breaker_state": self.breaker.state,
            "cooldown_left_s": round(self._cooldown_left(self._clock()), 3),
            "last_action_t_mono": last,
            "actions_total": actions,
            "recent": recent,
        }
