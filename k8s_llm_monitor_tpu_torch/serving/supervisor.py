"""Engine supervisor: rebuild-and-replay over a dead or wedged step loop.

The engine service is resilient *within* a healthy process; this module
survives the process-lifecycle failures Kubernetes actually deals out.
The :class:`EngineSupervisor` owns the :class:`EngineService` and watches
two death signals:

  * ``service._dead``          — the step loop raised and exited;
  * a stale step-loop heartbeat with work pending — the loop is wedged
    inside a dispatch that will never return.

On either, it tears the service down, rebuilds the engine through the
injected ``engine_factory`` (a fresh engine means a fresh KV allocator —
free count back to baseline by construction), and re-admits every
incomplete request — idempotent by request id, with already-streamed
tokens folded into the prompt and ``max_tokens`` trimmed so no token is
ever generated twice (the same recompute idiom as the engine's
``_requeue_or_fail``).  Restarts burn a ``max_restarts`` budget with
``Backoff`` between attempts; past the budget the supervisor gives up,
fails the survivors with cause, and pins UNHEALTHY.

Request durability spans processes through the optional
:class:`~k8s_llm_monitor_tpu_torch.resilience.journal.RequestJournal`: admits
are journaled write-ahead, progress is checkpointed from the service's
observer hook (before tokens reach the caller), and a warm start replays
whatever the previous process never finished — before traffic is served.

States (exporter ``lifecycle_state`` gauge):

    serving -> rebuilding -> serving        (successful restart)
    serving -> rebuilding -> failed         (budget exhausted)
    serving -> terminating -> stopped       (SIGTERM graceful handover)

Admission is refused while rebuilding/terminating with a retriable
:class:`OverloadedError` carrying a backoff-derived Retry-After hint.
"""

from __future__ import annotations

import atexit
import dataclasses
import itertools
import logging
import os
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Optional

from k8s_llm_monitor_tpu_torch.devtools.lockcheck import guarded_by, make_lock
from k8s_llm_monitor_tpu_torch.observability.flight import get_flight_recorder
from k8s_llm_monitor_tpu_torch.observability.tracing import get_tracer
from k8s_llm_monitor_tpu_torch.resilience.errors import OverloadedError
from k8s_llm_monitor_tpu_torch.resilience.health import HealthMonitor
from k8s_llm_monitor_tpu_torch.resilience.journal import (
    JournaledRequest,
    RequestJournal,
)
from k8s_llm_monitor_tpu_torch.resilience.retry import Backoff
from k8s_llm_monitor_tpu_torch.resilience.slo import DEFAULT_CLASS
from k8s_llm_monitor_tpu_torch.resilience.tenancy import (
    DEFAULT_TENANT,
    TenantGovernor,
    normalize_tenant,
)
from k8s_llm_monitor_tpu_torch.serving.engine import (
    GenerationResult,
    InferenceEngine,
    SamplingParams,
)
from k8s_llm_monitor_tpu_torch.serving.service import EngineService, RequestHandle

logger = logging.getLogger("serving.supervisor")

SERVING = "serving"
REBUILDING = "rebuilding"
TERMINATING = "terminating"
STOPPED = "stopped"
FAILED = "failed"
LIFECYCLE_STATES = (SERVING, REBUILDING, TERMINATING, STOPPED, FAILED)


@dataclass
class _Tracked:
    """Everything needed to re-admit one in-flight request."""

    prompt_ids: list[int]
    sampling: SamplingParams
    deadline_s: float
    arrival_unix: float
    emitted: list[int] = field(default_factory=list)
    handle: Optional[RequestHandle] = None
    slo_class: str = DEFAULT_CLASS
    tenant: str = DEFAULT_TENANT


def _sampling_from_dict(data: dict) -> SamplingParams:
    fields = {f.name for f in dataclasses.fields(SamplingParams)}
    return SamplingParams(**{k: v for k, v in (data or {}).items()
                             if k in fields})


@guarded_by("_lock", "_state", "restarts", "replayed_total")
class EngineSupervisor:
    """Owns the EngineService; rebuilds the engine and replays survivors.

    ``engine_factory`` must return a *fresh* ``InferenceEngine`` each call
    (weights may be shared; KV pages and host state must not be).  With
    ``max_restarts=0`` a loop death is terminal — equivalent to the
    unsupervised service, plus journaling.

    KV tiering note: a factory that closes over one shared
    ``HostKVTier`` and passes it as the engine's ``host_kv_tier`` kwarg
    keeps *spilled* prefix pages alive across rebuilds — the rebuilt
    engine starts with a fresh device pool but rehydrates demoted
    prefixes from host RAM on their next hit.  If the tier was lost too
    (process restart), the replay machinery above is the fallback: the
    prompt re-prefills from tokens, so a lost spill entry can never lose
    tokens — only the latency win.
    """

    def __init__(
        self,
        engine_factory: Callable[[], InferenceEngine],
        *,
        journal: RequestJournal | None = None,
        health: HealthMonitor | None = None,
        max_restarts: int = 3,
        backoff: Backoff | None = None,
        heartbeat_timeout_s: float = 30.0,
        poll_interval_s: float = 0.1,
        clock=time.monotonic,
        governor: TenantGovernor | None = None,
    ):
        self.engine_factory = engine_factory
        self.journal = journal
        self.health = health or HealthMonitor()
        # Supervisor-owned so per-tenant reservations survive engine
        # rebuilds (the replacement EngineService gets the same instance)
        # and warm starts can restore quota state from the journal.
        self.governor = governor
        self.max_restarts = max_restarts
        self.backoff = backoff or Backoff(base_s=0.2, cap_s=5.0, jitter=0.0)
        self.heartbeat_timeout_s = heartbeat_timeout_s
        self.poll_interval_s = poll_interval_s
        self._clock = clock
        self._ids = itertools.count()
        self._pid = os.getpid()

        self.restarts = 0        # engine rebuilds performed
        self.replayed_total = 0  # requests re-admitted (rebuild + warm start)
        self._tracked: dict[str, _Tracked] = {}
        self._state = SERVING
        self._death = threading.Event()   # woken by on_death for fast detect
        self._stop = threading.Event()

        self.service = self._build_service()
        # Created last (lockcheck: writes before the lock exists are
        # construction) — but before warm-start replay and the monitor
        # thread, which both take it.
        self._lock = make_lock("serving.supervisor")
        if journal is not None and journal.incomplete_recovered:
            self._replay_recovered(journal.incomplete_recovered)
        self._monitor = threading.Thread(
            target=self._monitor_loop, name="engine-supervisor", daemon=True)
        self._monitor.start()
        atexit.register(self.close)

    # -- accessors -------------------------------------------------------

    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    @property
    def engine(self) -> InferenceEngine:
        return self.service.engine

    @property
    def journal_bytes(self) -> int:
        return self.journal.size_bytes if self.journal is not None else 0

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "state": self._state,
                "restarts": self.restarts,
                "max_restarts": self.max_restarts,
                "replayed_total": self.replayed_total,
                "tracked": len(self._tracked),
                "journal_bytes": self.journal_bytes,
            }

    # -- construction ----------------------------------------------------

    def _build_service(self) -> EngineService:
        engine = self.engine_factory()
        svc = EngineService(engine, health=self.health,
                            on_death=self._on_service_death,
                            governor=self.governor)
        svc.observer = self._observe
        return svc

    def _on_service_death(self, reason: str) -> None:
        # Called from the dying step-loop thread: just wake the monitor —
        # the rebuild must not run on a thread that's about to re-raise.
        self._death.set()

    # -- submission ------------------------------------------------------

    def submit(
        self,
        prompt_ids: list[int],
        sampling: SamplingParams | None = None,
        request_id: str | None = None,
        deadline_s: float = 0.0,
        slo_class: str = DEFAULT_CLASS,
        tenant: str = DEFAULT_TENANT,
    ) -> RequestHandle:
        """Journal (write-ahead), track, and admit one request."""
        # Normalized HERE so the journal never records a raw tenant string
        # (replay re-derives quota state from what the WAL says).
        tenant = normalize_tenant(tenant)
        if request_id is None:
            # Unique across process restarts sharing one journal dir.
            # Assigned BEFORE any refusal so every 429/503 body carries
            # the id (joinable with traces and journal records).
            request_id = f"req-{self._pid}-{next(self._ids)}"
        with self._lock:
            state = self._state
        if state == REBUILDING:
            raise OverloadedError(
                "engine rebuilding", retriable=True,
                retry_after_s=self.backoff.delay(0) + 0.5,
                slo_class=slo_class, request_id=request_id,
                tenant=tenant)
        if state != SERVING:
            raise OverloadedError(f"lifecycle state {state}",
                                  retriable=False, slo_class=slo_class,
                                  request_id=request_id, tenant=tenant)
        sampling = sampling or SamplingParams()
        tracked = _Tracked(list(prompt_ids), sampling, deadline_s,
                           time.time(), slo_class=slo_class, tenant=tenant)
        # Track before the engine can emit a single token for this id, and
        # journal before the engine can accept it (write-AHEAD).
        with self._lock:
            self._tracked[request_id] = tracked
        if self.journal is not None:
            self.journal.log_admit(request_id, prompt_ids, sampling,
                                   deadline_s, tracked.arrival_unix,
                                   slo_class=slo_class, tenant=tenant)
        try:
            handle = self.service.submit(
                prompt_ids, sampling, request_id=request_id,
                deadline_s=deadline_s, slo_class=slo_class, tenant=tenant)
        except BaseException as exc:
            # Refused (shed/dead): untrack and tombstone the admit record.
            with self._lock:
                self._tracked.pop(request_id, None)
            if self.journal is not None:
                self.journal.log_complete(request_id)
            if isinstance(exc, RuntimeError):
                # The service died between the state check and the submit:
                # a rebuild is imminent — tell the client to retry.
                raise OverloadedError(
                    "engine restarting", retriable=True,
                    retry_after_s=self.backoff.delay(0) + 0.5,
                    slo_class=slo_class, request_id=request_id) from exc
            raise
        tracked.handle = handle
        return handle

    # -- control plane ---------------------------------------------------

    def call(self, fn: Callable[[InferenceEngine], object],
             timeout: float = 30.0):
        """Run ``fn(engine)`` on the *current* service's step thread
        (serving/service.py ``EngineService.call``) — the seam the
        ``/api/v1/kv`` endpoints use for prefix export/install.  Refused
        with a retriable OverloadedError while rebuilding: the engine is
        mid-swap and a call could land on either incarnation."""
        with self._lock:
            state = self._state
        if state == REBUILDING:
            raise OverloadedError(
                "engine rebuilding", retriable=True,
                retry_after_s=self.backoff.delay(0) + 0.5)
        if state != SERVING:
            raise OverloadedError(f"lifecycle state {state}",
                                  retriable=False)
        try:
            return self.service.call(fn, timeout=timeout)
        except RuntimeError as exc:
            # Service died between the state check and the call: a
            # rebuild is imminent — same shape as the submit() race.
            raise OverloadedError(
                "engine restarting", retriable=True,
                retry_after_s=self.backoff.delay(0) + 0.5) from exc

    # -- progress observation (called from the step-loop thread) ---------

    def _observe(self, request_id: str, toks: list[int],
                 result: Optional[GenerationResult]) -> None:
        with self._lock:
            tracked = self._tracked.get(request_id)
            if tracked is not None and toks:
                tracked.emitted.extend(int(t) for t in toks)
            if result is not None:
                self._tracked.pop(request_id, None)
        if self.journal is not None:
            if toks:
                self.journal.log_progress(request_id, [int(t) for t in toks])
            if result is not None:
                self.journal.log_complete(request_id)

    # -- death detection -------------------------------------------------

    def _monitor_loop(self) -> None:
        while not self._stop.is_set():
            self._death.wait(timeout=self.poll_interval_s)
            self._death.clear()
            if self._stop.is_set():
                return
            with self._lock:
                if self._state != SERVING:
                    continue
            svc = self.service
            with svc._handles_lock:
                dead = svc._dead
            reason = dead
            if reason is None and svc.engine.has_work:
                stale_s = self._clock() - svc.last_heartbeat
                if stale_s > self.heartbeat_timeout_s:
                    reason = (f"step loop wedged: no heartbeat for "
                              f"{stale_s:.1f}s with work pending")
            if reason is not None:
                try:
                    self._restart(reason)
                except Exception:  # noqa: BLE001 — monitor must survive
                    logger.exception("engine restart failed")

    # -- rebuild-and-replay ----------------------------------------------

    def _restart(self, reason: str) -> None:
        with self._lock:
            if self._state != SERVING:
                return
            self._state = REBUILDING
            self.restarts += 1
            attempt = self.restarts
        logger.warning("engine restart %d/%d: %s",
                       attempt, self.max_restarts, reason)
        # Dump the flight artifact before recovery mutates state: the span
        # ring and event log still describe the failing incarnation.
        rec = get_flight_recorder()
        rec.note("supervisor_rebuild", reason=reason, attempt=attempt)
        rec.dump("supervisor_rebuild",
                 extra={"reason": reason, "attempt": attempt})
        old = self.service
        handles = old.detach_handles()
        # A wedged loop may wake up long after the rebuild: its late tokens
        # are from a replaced engine incarnation and must not reach the
        # tracked state (they would duplicate what the new engine re-emits).
        old.observer = None
        # Close the dying incarnation's request spans: phase spans already
        # recorded parent them, and replay mints fresh contexts — without
        # this the old parents would never be emitted (orphan spans).
        tracer = get_tracer()
        t_now = time.monotonic()
        for rid, h in handles.items():
            ctx = getattr(h, "trace", None)
            if ctx is not None:
                tracer.record(
                    "engine.request", t_now, t_now, ctx, status="error",
                    span_id=ctx.span_id, parent_id=ctx.parent_id,
                    attrs={"request_id": rid, "outcome": "rebuild"})
        if attempt > self.max_restarts:
            self._give_up(f"restart budget exhausted after: {reason}",
                          handles)
            return
        time.sleep(self.backoff.delay(attempt - 1))
        try:
            old.stop(timeout=2.0)
        except Exception:  # noqa: BLE001 — the loop may be unjoinable (wedged)
            logger.exception("old service stop failed (continuing)")
        try:
            svc = self._build_service()
        except Exception as exc:  # noqa: BLE001 — factory failed: terminal
            logger.exception("engine factory failed during restart")
            self._give_up(f"engine rebuild failed: {exc!r}", handles)
            return
        # Fresh engine, fresh KV allocator: free count is back to its
        # baseline by construction.
        self.health.clear_dead()
        self.service = svc
        with self._lock:
            pending = list(self._tracked.items())
        replayed = 0
        for rid, tracked in pending:
            tracked.handle = handles.get(rid, tracked.handle)
            if self._replay_one(rid, tracked):
                replayed += 1
        with self._lock:
            self.replayed_total += replayed
            self._state = SERVING
        logger.info("engine rebuilt: %d request(s) replayed", replayed)

    def _replay_one(self, rid: str, tracked: _Tracked) -> bool:
        """Re-admit one tracked request on the current service.  Already-
        emitted tokens are folded into the prompt and trimmed from the
        budget — replay never re-generates a delivered token."""
        with self._lock:
            if rid not in self._tracked:
                return False  # resolved (or refused) while we snapshotted
        emitted = list(tracked.emitted)
        remaining = tracked.sampling.max_tokens - len(emitted)
        if remaining < 1:
            # Budget already delivered: finish the request as-is.
            self._finish_tracked(rid, tracked, GenerationResult(
                request_id=rid, token_ids=emitted, finish_reason="length",
                ttft_s=0.0, latency_s=0.0))
            return False
        deadline_s = tracked.deadline_s
        if deadline_s > 0:
            deadline_s -= time.time() - tracked.arrival_unix
            if deadline_s <= 0:
                self._finish_tracked(rid, tracked, GenerationResult(
                    request_id=rid, token_ids=emitted, finish_reason="error",
                    ttft_s=0.0, latency_s=0.0,
                    error="deadline exceeded during engine rebuild"))
                return False
        if tracked.handle is not None:
            # Streamed tokens stay streamed; the final result still carries
            # the complete output.
            tracked.handle._replay_prefix = emitted
        sampling = dataclasses.replace(tracked.sampling,
                                       max_tokens=remaining)
        try:
            tracked.handle = self.service.submit(
                tracked.prompt_ids + emitted, sampling, request_id=rid,
                deadline_s=deadline_s, force=True, handle=tracked.handle,
                slo_class=tracked.slo_class, tenant=tracked.tenant)
        except Exception as exc:  # noqa: BLE001 — replay refusal is terminal
            self._finish_tracked(rid, tracked, GenerationResult(
                request_id=rid, token_ids=emitted, finish_reason="error",
                ttft_s=0.0, latency_s=0.0,
                error=f"replay failed: {exc!r}"))
            return False
        return True

    def _finish_tracked(self, rid: str, tracked: _Tracked,
                        result: GenerationResult) -> None:
        with self._lock:
            self._tracked.pop(rid, None)
        if self.governor is not None:
            # Settle is idempotent; this covers terminal paths that never
            # re-reach the service (budget-done, deadline, replay refusal)
            # so the tenant is charged only for tokens actually emitted.
            self.governor.settle(rid)
        if self.journal is not None:
            self.journal.log_complete(rid)
        if tracked.handle is not None:
            tracked.handle._replay_prefix = []  # token_ids already complete
            tracked.handle._push([], result)

    def _give_up(self, reason: str, handles: dict[str, RequestHandle]) -> None:
        logger.error("supervisor giving up: %s", reason)
        get_flight_recorder().note("supervisor_give_up", reason=reason)
        with self._lock:
            self._state = FAILED
            pending = list(self._tracked.items())
        self.health.set_dead(reason)
        for rid, tracked in pending:
            tracked.handle = handles.get(rid, tracked.handle)
            self._finish_tracked(rid, tracked, GenerationResult(
                request_id=rid, token_ids=list(tracked.emitted),
                finish_reason="error", ttft_s=0.0, latency_s=0.0,
                error=reason))

    # -- warm start (previous process's journal) -------------------------

    def _replay_recovered(self, recovered: list[JournaledRequest]) -> None:
        """Re-admit requests a previous process accepted but never
        finished.  Runs during construction — strictly before the HTTP
        listener exists, so replay always precedes fresh traffic."""
        replayed = 0
        for rec in recovered:
            tracked = _Tracked(
                prompt_ids=list(rec.prompt_ids),
                sampling=_sampling_from_dict(rec.sampling),
                deadline_s=rec.deadline_s,
                arrival_unix=rec.arrival_unix or time.time(),
                emitted=list(rec.emitted),
                slo_class=rec.slo_class,
                tenant=rec.tenant,
            )
            with self._lock:
                self._tracked[rec.request_id] = tracked
            if self.governor is not None:
                # Rebuild the tenant's reservation exactly as the WAL
                # recorded it: tokens already streamed are pre-charged
                # (force-taken, possibly into debt) so the eventual
                # settle charges emitted tokens once — a crash can never
                # launder quota, and a torn tail for one tenant cannot
                # perturb another tenant's accounting (records are
                # per-request and tenant-tagged).
                self.governor.restore(
                    rec.request_id, rec.tenant,
                    max_tokens=tracked.sampling.max_tokens,
                    delivered=len(rec.emitted))
            if self._replay_one(rec.request_id, tracked):
                replayed += 1
        with self._lock:
            self.replayed_total += replayed
        if recovered:
            logger.info("warm start: %d journaled request(s) recovered, "
                        "%d replayed", len(recovered), replayed)

    # -- graceful handover (SIGTERM) -------------------------------------

    def shutdown(self, grace_s: float = 20.0) -> bool:
        """Terminating handover: refuse admission, flip readiness via
        DRAINING, drain inflight within ``grace_s``, stop the loop, seal
        the journal.  Returns True when fully drained in time (stragglers
        stay journaled for the next process to replay)."""
        with self._lock:
            if self._state in (TERMINATING, STOPPED):
                return True
            self._state = TERMINATING
        self._stop.set()
        self._death.set()
        self.health.set_draining(True)
        svc = self.service
        drained = svc.drain(timeout=grace_s) if grace_s > 0 else False
        try:
            svc.stop(timeout=5.0)
        except Exception:  # noqa: BLE001 — wedged loop: proceed to seal
            logger.exception("service stop failed during shutdown")
        if self.journal is not None:
            self.journal.seal()
        self._monitor.join(timeout=2.0)
        with self._lock:
            self._state = STOPPED
        atexit.unregister(self.close)
        return drained

    def close(self) -> None:
        """atexit / test teardown: immediate stop, journal kept replayable."""
        self.shutdown(grace_s=0.0)
