"""Replica membership, health, and load-signal tracking for the fleet tier.

The ``ReplicaRegistry`` is the router's single source of truth about the
fleet: which replicas exist, which are ready (probed through each replica's
``/readyz`` / ``HealthMonitor`` semantics), what their last stats snapshot
said (queue tokens, busy slots, prefix-cache hit rate — the weighted
least-loaded signal), how many router-side requests are in flight on each,
and each replica's ``CircuitBreaker`` state.

Probing is pull-based: ``refresh()`` polls every replica once (tests and
the bench call it synchronously); ``start_probes()`` runs the same poll on
a background thread for the server role.  A probe failure marks the
replica unready and records a breaker failure — the breaker, not the probe
loop, decides when to start trusting the replica again (half-open trial on
the next dispatch after the cooldown).
"""

from __future__ import annotations

import dataclasses
import logging
import threading
import time
from typing import Optional

from k8s_llm_monitor_tpu_torch.devtools.lockcheck import guarded_by, make_lock
from k8s_llm_monitor_tpu_torch.resilience.retry import CircuitBreaker

logger = logging.getLogger("fleet.registry")


@dataclasses.dataclass
class ReplicaStats:
    """One replica's load snapshot — the shape ``GET /api/v1/stats``
    serves and ``Replica.stats()`` returns."""

    queue_depth: int = 0
    queue_tokens: int = 0
    busy_slots: int = 0
    total_slots: int = 0
    prefix_hits: int = 0
    prefix_misses: int = 0
    # Per-SLO-class queued tokens and the replica's brownout rung
    # (resilience/slo.py) — class-aware routing signals; absent keys mean
    # a pre-class replica (treated as all-standard, normal).
    queue_by_class: dict = dataclasses.field(default_factory=dict)
    brownout: int = 0
    # KV tier snapshot (engine ``kv_tier_stats()``): quant mode, host
    # spill/restore counters.  Absent on pre-tiering replicas — routing
    # never requires it; the fleet exporter and migration diagnostics do.
    kv_tier: dict = dataclasses.field(default_factory=dict)
    # Signal-scraper inputs (telemetry plane): admission headroom in
    # tokens (None on pre-telemetry replicas — None, not 0, so the
    # scraper records a NaN marker instead of fake emptiness), per-class
    # shed/preemption totals, and the per-class TTFT EMAs (classes with
    # no completion yet are simply absent).
    headroom_tokens: Optional[float] = None
    shed_by_class: dict = dataclasses.field(default_factory=dict)
    ttft_ema_by_class: dict = dataclasses.field(default_factory=dict)
    preemptions_by_class: dict = dataclasses.field(default_factory=dict)
    # Disaggregation role announced by the replica itself (FLEET_ROLE):
    # "prefill" | "decode" | "unified".  Absent on pre-role replicas —
    # treated as unified, so a mixed fleet keeps routing.
    role: str = "unified"
    # Lifecycle: a draining replica finishes its in-flight streams but
    # must receive no new dispatches and must not win prefix affinity.
    draining: bool = False

    @property
    def prefix_hit_rate(self) -> float:
        seen = self.prefix_hits + self.prefix_misses
        return self.prefix_hits / seen if seen else 0.0

    @classmethod
    def from_payload(cls, payload: dict) -> "ReplicaStats":
        """Parse the ``/api/v1/stats`` response body (``engine`` block)."""
        eng = (payload or {}).get("engine") or {}
        pc = eng.get("prefix_cache") or {}
        by_class = eng.get("queue_tokens_by_class") or {}
        headroom = eng.get("admission_headroom_tokens")
        return cls(
            queue_depth=int(eng.get("queue_depth", 0)),
            queue_tokens=int(eng.get("queue_tokens", 0)),
            busy_slots=int(eng.get("busy_slots", 0)),
            total_slots=int(eng.get("total_slots", 0)),
            prefix_hits=int(pc.get("hits", 0)),
            prefix_misses=int(pc.get("misses", 0)),
            queue_by_class={str(k): int(v) for k, v in by_class.items()},
            brownout=int(eng.get("brownout", 0)),
            kv_tier=dict(eng.get("kv_tier") or {}),
            headroom_tokens=(float(headroom) if headroom is not None
                             else None),
            shed_by_class={str(k): int(v) for k, v in
                           (eng.get("shed_by_class") or {}).items()},
            ttft_ema_by_class={str(k): float(v) for k, v in
                               (eng.get("ttft_ema_by_class") or {}).items()},
            preemptions_by_class={
                str(k): int(v) for k, v in
                (eng.get("preemptions_by_class") or {}).items()},
            role=str(eng.get("role") or "unified"),
            draining=bool(eng.get("draining", False)),
        )


@dataclasses.dataclass
class _Entry:
    replica: object
    breaker: CircuitBreaker
    ready: bool = False
    reason: str = "never probed"
    stats: ReplicaStats = dataclasses.field(default_factory=ReplicaStats)
    inflight: int = 0
    last_probe_s: float = 0.0
    dispatches: int = 0
    failures: int = 0


@dataclasses.dataclass
class Candidate:
    """A dispatchable replica as the routing policies see it."""

    replica_id: str
    replica: object
    stats: ReplicaStats
    inflight: int


@guarded_by("_lock", "_entries")
class ReplicaRegistry:
    """Thread-safe replica table.  Dispatch paths read ``candidates()``;
    the probe loop and the router's outcome callbacks write."""

    def __init__(self, breaker_failures: int = 3,
                 breaker_cooldown_s: float = 5.0):
        self._breaker_failures = breaker_failures
        self._breaker_cooldown_s = breaker_cooldown_s
        self._probe_thread: Optional[threading.Thread] = None
        self._probe_stop = threading.Event()
        # The cadence start_probes() runs at — the staleness yardstick
        # the telemetry plane compares probe ages against.
        self.probe_interval_s: float = 5.0
        self._entries: dict[str, _Entry] = {}
        # Lifecycle subscribers: fired outside the lock.  on_drain fires
        # once per rising edge of a replica's draining flag (the router's
        # prefix-handout sweep); on_remove fires when a replica leaves the
        # table (router/scraper state GC).
        self._on_drain: list = []
        self._on_remove: list = []
        # Created last (lockcheck: writes before the lock exists are
        # construction, not races).
        self._lock = make_lock("fleet.registry")

    # -- membership -----------------------------------------------------

    def add(self, replica) -> None:
        entry = _Entry(
            replica=replica,
            breaker=CircuitBreaker(
                failure_threshold=self._breaker_failures,
                cooldown_s=self._breaker_cooldown_s),
        )
        with self._lock:
            self._entries[replica.replica_id] = entry

    def remove(self, replica_id: str) -> None:
        """Drop a replica from the table.  Its breaker and inflight
        counters die with the entry — nothing keeps probing (or alarming
        on) a replica that left the fleet — and on_remove subscribers get
        one shot at GC'ing their own per-replica state."""
        with self._lock:
            removed = self._entries.pop(replica_id, None) is not None
        if removed:
            for cb in list(self._on_remove):
                try:
                    cb(replica_id)
                except Exception:  # noqa: BLE001 — GC hooks must not raise
                    logger.exception("on_remove hook failed for %s",
                                     replica_id)

    def subscribe_drain(self, callback) -> None:
        """``callback(replica_id)`` on the rising edge of a replica's
        draining announcement (probe-observed).  Called outside the lock."""
        self._on_drain.append(callback)

    def subscribe_remove(self, callback) -> None:
        """``callback(replica_id)`` after a replica is removed."""
        self._on_remove.append(callback)

    def ids(self) -> list[str]:
        with self._lock:
            return list(self._entries)

    def get(self, replica_id: str) -> Optional[_Entry]:
        with self._lock:
            return self._entries.get(replica_id)

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    # -- probing --------------------------------------------------------

    def refresh(self, replica_id: str | None = None) -> None:
        """Probe one replica (or all): readiness + stats.  A probe that
        raises marks the replica unready and feeds the breaker; it never
        propagates — an unreachable replica is a routing fact, not a
        registry error."""
        with self._lock:
            items = [(rid, e.replica) for rid, e in self._entries.items()
                     if replica_id is None or rid == replica_id]
        for rid, replica in items:
            ready, reason, stats = False, "", None
            try:
                ready = bool(replica.readyz())
                if not ready:
                    reason = "replica reports not ready"
                stats = replica.stats()
            except Exception as exc:  # noqa: BLE001 — probe must not raise
                ready, reason = False, f"probe failed: {exc}"
            drain_edge = False
            with self._lock:
                entry = self._entries.get(rid)
                if entry is None:
                    continue
                was_ready = entry.ready
                was_draining = entry.stats.draining
                entry.ready = ready
                entry.reason = reason
                entry.last_probe_s = time.monotonic()
                if stats is not None:
                    entry.stats = stats
                    drain_edge = stats.draining and not was_draining
                if ready:
                    entry.breaker.record_success()
                else:
                    entry.breaker.record_failure()
            if ready != was_ready:
                logger.info("replica %s -> %s%s", rid,
                            "ready" if ready else "unready",
                            f" ({reason})" if reason else "")
            if drain_edge:
                logger.info("replica %s announced draining", rid)
                for cb in list(self._on_drain):
                    try:
                        cb(rid)
                    except Exception:  # noqa: BLE001 — best-effort sweep
                        logger.exception("on_drain hook failed for %s", rid)

    def start_probes(self, interval_s: float = 5.0) -> None:
        if self._probe_thread is not None:
            return
        self.probe_interval_s = float(interval_s)
        self._probe_stop.clear()

        def _loop() -> None:
            while not self._probe_stop.wait(timeout=interval_s):
                self.refresh()

        self._probe_thread = threading.Thread(
            target=_loop, name="fleet-probes", daemon=True)
        self._probe_thread.start()

    def stop_probes(self) -> None:
        self._probe_stop.set()
        if self._probe_thread is not None:
            self._probe_thread.join(timeout=5.0)
            self._probe_thread = None

    # -- dispatch bookkeeping -------------------------------------------

    def candidates(self) -> list[Candidate]:
        """Ready replicas whose breaker is not refusing calls, with the
        stats the policies rank on.  Breakers are consulted read-only here;
        the half-open trial slot is claimed at dispatch time via
        ``before_call`` so concurrent dispatches can't all pile onto one
        recovering replica."""
        out = []
        with self._lock:
            for rid, e in self._entries.items():
                if e.ready and not e.stats.draining \
                        and e.breaker.state != "open":
                    out.append(Candidate(rid, e.replica, e.stats, e.inflight))
        return out

    def note_dispatch(self, replica_id: str) -> None:
        with self._lock:
            entry = self._entries.get(replica_id)
            if entry is not None:
                entry.inflight += 1
                entry.dispatches += 1

    def note_done(self, replica_id: str, ok: bool) -> None:
        with self._lock:
            entry = self._entries.get(replica_id)
            if entry is None:
                return
            entry.inflight = max(0, entry.inflight - 1)
            if ok:
                entry.breaker.record_success()
            else:
                entry.failures += 1
                entry.breaker.record_failure()

    def mark_unready(self, replica_id: str, reason: str) -> None:
        """Failover fast-path: the router observed this replica die; don't
        wait for the next probe to stop routing there."""
        with self._lock:
            entry = self._entries.get(replica_id)
            if entry is not None:
                entry.ready = False
                entry.reason = reason

    # -- observability ---------------------------------------------------

    def snapshot(self) -> dict:
        """Per-replica view for ``/api/v1/stats``, the exporter, and the
        signal scraper.  ``probe_age_s`` is seconds since the last
        completed probe — None until the first probe finishes (the
        telemetry plane treats None as maximally stale)."""
        now = time.monotonic()
        with self._lock:
            return {
                rid: {
                    "ready": e.ready,
                    "reason": e.reason,
                    "role": e.stats.role,
                    "draining": e.stats.draining,
                    "inflight": e.inflight,
                    "dispatches": e.dispatches,
                    "failures": e.failures,
                    "breaker_state": e.breaker.state,
                    "queue_depth": e.stats.queue_depth,
                    "queue_tokens": e.stats.queue_tokens,
                    "queue_by_class": dict(e.stats.queue_by_class),
                    "brownout": e.stats.brownout,
                    "busy_slots": e.stats.busy_slots,
                    "total_slots": e.stats.total_slots,
                    "prefix_hit_rate": round(e.stats.prefix_hit_rate, 4),
                    "kv_tier": dict(e.stats.kv_tier),
                    "headroom_tokens": e.stats.headroom_tokens,
                    "shed_by_class": dict(e.stats.shed_by_class),
                    "ttft_ema_by_class": dict(e.stats.ttft_ema_by_class),
                    "preemptions_by_class":
                        dict(e.stats.preemptions_by_class),
                    "probe_age_s": (round(now - e.last_probe_s, 3)
                                    if e.last_probe_s > 0 else None),
                }
                for rid, e in self._entries.items()
            }
