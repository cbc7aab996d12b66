"""Replica adapters: one interface, two transports.

``LocalReplica`` wraps an in-process ``EngineService`` (or a supervised
``EngineSupervisor``) so tests and the bench can run a 2–4 replica fleet in
one CPU process — it speaks the token-level generation interface the
router's failover/hedging machinery needs (``generate`` → ``RequestHandle``).

``HTTPReplica`` fronts a remote monitor-server replica over its existing
HTTP API: ``/readyz`` + ``/api/v1/stats`` for probing (GETs, retried
through the shared ``Backoff`` budget), ``/api/v1/query`` SSE and
``/api/v1/analyze`` for traffic (POSTs, never retried — the router's
failover owns re-dispatch).  All calls carry explicit socket timeouts via
``monitor.client.ApiClient``.

Capability split: LocalReplica is token-level (``supports_tokens``),
HTTPReplica is text-level (``supports_query`` — the wire protocol streams
answer-text deltas, not token ids).  The router routes each request shape
over the replicas that support it.
"""

from __future__ import annotations

import logging

from k8s_llm_monitor_tpu_torch.fleet.registry import ReplicaStats
from k8s_llm_monitor_tpu_torch.resilience.tenancy import DEFAULT_TENANT

logger = logging.getLogger("fleet.replica")


class ReplicaUnavailable(RuntimeError):
    """The replica could not take this request (connection refused, died,
    adapter closed).  Routing-level signal: try another replica."""


class Replica:
    """Adapter interface the registry probes and the router dispatches on."""

    replica_id: str = ""
    supports_tokens = False
    supports_query = False
    supports_kv_migration = False

    # -- probing --------------------------------------------------------

    def readyz(self) -> bool:
        raise NotImplementedError

    def stats(self) -> ReplicaStats:
        raise NotImplementedError

    # -- token-level generation (in-process replicas) -------------------

    def generate(self, prompt_ids: list[int], sampling=None,
                 request_id: str | None = None, deadline_s: float = 0.0,
                 slo_class: str = "standard",
                 tenant: str = DEFAULT_TENANT):
        """Submit one generation; returns a ``RequestHandle``.  The quota
        charge for ``tenant`` already happened at the router — the replica
        only uses it for KV namespacing and journal accounting."""
        raise NotImplementedError(f"{self.replica_id}: token interface")

    # -- text-level query API (HTTP replicas) ---------------------------

    def query(self, question: str, slo_class: str = "interactive",
              tenant: str = DEFAULT_TENANT) -> dict:
        raise NotImplementedError(f"{self.replica_id}: query interface")

    def query_stream(self, question: str, slo_class: str = "interactive",
                     tenant: str = DEFAULT_TENANT):
        """Returns (request_id, model, iterator of text deltas)."""
        raise NotImplementedError(f"{self.replica_id}: query interface")

    def analyze(self, payload: dict,
                tenant: str = DEFAULT_TENANT) -> dict:
        raise NotImplementedError(f"{self.replica_id}: query interface")

    def diagnoses(self, limit: int = 0) -> dict:
        """Verdict history from the replica's standing diagnosis pipeline."""
        raise NotImplementedError(f"{self.replica_id}: query interface")

    # -- KV prefix migration (serving/kv_tier.py blob framing) ----------

    def fetch_prefix(self, token_ids: list[int],
                     tenant: str = DEFAULT_TENANT):
        """Framed KV pages for the longest cached prefix of ``token_ids``
        under ``tenant``'s namespace (``bytes``), or None on a cache miss.
        The router's migration path calls this on the prefix-affinity
        *owner* when dispatch landed elsewhere."""
        raise NotImplementedError(f"{self.replica_id}: kv migration")

    def install_prefix(self, blob: bytes,
                       tenant: str | None = None) -> str:
        """Install a fetched prefix blob into this replica's KV pool.
        With ``tenant`` set, a blob whose header names a different tenant
        is refused (``tenant_mismatch``).  Returns the engine's outcome
        string: ``installed`` / ``cached`` / ``incompatible`` /
        ``nospace`` / ``tenant_mismatch``."""
        raise NotImplementedError(f"{self.replica_id}: kv migration")

    # -- tracing ---------------------------------------------------------

    def fetch_trace(self, trace_id: str) -> list[dict]:
        """Span dicts this replica recorded for ``trace_id`` (may be
        empty).  The router's ``/api/v1/trace/<id>`` merge calls this on
        every replica to stitch one cross-process timeline."""
        return []

    def close(self) -> None:
        pass


class LocalReplica(Replica):
    """In-process replica: an ``EngineService`` (optionally owned by an
    ``EngineSupervisor``) behind the replica interface.

    ``kill()`` is the chaos hook: it stops the service abruptly so every
    in-flight handle resolves with an error result — exactly what the
    router's mid-stream failover must survive.
    """

    supports_tokens = True
    supports_kv_migration = True

    def __init__(self, replica_id: str, service=None, supervisor=None,
                 role: str = "unified"):
        assert (service is None) != (supervisor is None), \
            "exactly one of service/supervisor"
        self.replica_id = replica_id
        self.supervisor = supervisor
        self._service = service
        self._killed = False
        self.role = role
        self._draining = False

    @property
    def service(self):
        if self.supervisor is not None:
            return self.supervisor.service
        return self._service

    def readyz(self) -> bool:
        if self._killed:
            return False
        svc = self.service
        if svc is None:
            return False
        snap = svc.health.snapshot()
        ready = bool(snap["ready"])
        if self.supervisor is not None:
            ready = ready and self.supervisor.snapshot()["state"] == "serving"
        return ready

    def stats(self) -> ReplicaStats:
        svc = self.service
        if svc is None:
            raise ReplicaUnavailable(f"{self.replica_id}: no service")
        engine = svc.engine
        pc = engine.prefix_cache
        return ReplicaStats(
            queue_depth=engine.queue_depth,
            queue_tokens=engine.queue_tokens,
            busy_slots=engine.active_slots,
            total_slots=engine.ecfg.max_slots,
            prefix_hits=pc.hits if pc is not None else 0,
            prefix_misses=pc.misses if pc is not None else 0,
            queue_by_class=engine.queue_tokens_by_class(),
            brownout=engine.brownout() if engine.brownout is not None else 0,
            kv_tier=engine.kv_tier_stats(),
            headroom_tokens=float(engine.admission_headroom_tokens()),
            shed_by_class=dict(svc.shed_count_by_class),
            ttft_ema_by_class=dict(engine.ttft_ema_by_class),
            preemptions_by_class=dict(engine.preemptions_by_class),
            role=self.role,
            draining=self._draining,
        )

    def drain(self) -> None:
        """Announce draining: the next stats probe carries the flag, the
        router stops dispatching here, and in-flight streams finish (or
        fail over via the normal replay path).  ``close()`` remains the
        actual teardown — drain is an announcement, not a stop."""
        self._draining = True

    @property
    def draining(self) -> bool:
        return self._draining

    def generate(self, prompt_ids: list[int], sampling=None,
                 request_id: str | None = None, deadline_s: float = 0.0,
                 slo_class: str = "standard",
                 tenant: str = DEFAULT_TENANT):
        if self._killed:
            raise ReplicaUnavailable(f"{self.replica_id}: killed")
        try:
            if self.supervisor is not None:
                return self.supervisor.submit(
                    prompt_ids, sampling, request_id=request_id,
                    deadline_s=deadline_s, slo_class=slo_class,
                    tenant=tenant)
            return self.service.submit(
                prompt_ids, sampling, request_id=request_id,
                deadline_s=deadline_s, slo_class=slo_class, tenant=tenant)
        except RuntimeError as exc:
            # Dead service: a routing fact, not a caller error.
            raise ReplicaUnavailable(str(exc)) from exc

    def _call(self, fn):
        """Engine control call on the step thread (service/supervisor
        ``call`` seam); death/lifecycle refusals become routing facts."""
        if self._killed:
            raise ReplicaUnavailable(f"{self.replica_id}: killed")
        try:
            if self.supervisor is not None:
                return self.supervisor.call(fn)
            svc = self.service
            if svc is None:
                raise ReplicaUnavailable(f"{self.replica_id}: no service")
            return svc.call(fn)
        except (RuntimeError, TimeoutError) as exc:
            raise ReplicaUnavailable(str(exc)) from exc

    def fetch_prefix(self, token_ids: list[int],
                     tenant: str = DEFAULT_TENANT):
        ids = list(token_ids)
        return self._call(lambda e: e.export_prefix(ids, tenant=tenant))

    def install_prefix(self, blob: bytes,
                       tenant: str | None = None) -> str:
        return self._call(
            lambda e: e.install_prefix(blob, expected_tenant=tenant))

    def fetch_trace(self, trace_id: str) -> list[dict]:
        # In-process replicas share the process tracer: the router's
        # local spans_for() already saw these, and the merge dedups by
        # span id — returning them again is harmless but pointless.
        from k8s_llm_monitor_tpu_torch.observability.tracing import get_tracer

        return get_tracer().spans_for(trace_id)

    def kill(self, reason: str = "injected replica death") -> None:
        """Chaos hook: die abruptly.  Handles for in-flight generations
        resolve with error results (the router's failover trigger)."""
        self._killed = True
        logger.warning("replica %s killed: %s", self.replica_id, reason)
        svc = self.service
        if svc is not None:
            svc.stop(timeout=10.0)

    def close(self) -> None:
        self._killed = True
        if self.supervisor is not None:
            self.supervisor.shutdown(grace_s=0.0)
        elif self._service is not None:
            self._service.stop(timeout=5.0)


class HTTPReplica(Replica):
    """Remote monitor-server replica over its HTTP API (SSE streaming for
    queries; explicit timeouts on every socket via ``ApiClient``)."""

    supports_query = True
    supports_kv_migration = True

    def __init__(self, replica_id: str, base_url: str, *,
                 connect_timeout_s: float = 2.0, read_timeout_s: float = 30.0,
                 client=None):
        from k8s_llm_monitor_tpu_torch.monitor.client import ApiClient

        self.replica_id = replica_id
        self.base_url = base_url.rstrip("/")
        self.client = client or ApiClient(
            self.base_url,
            connect_timeout_s=connect_timeout_s,
            read_timeout_s=read_timeout_s)

    def readyz(self) -> bool:
        return self.client.readyz()

    def stats(self) -> ReplicaStats:
        return ReplicaStats.from_payload(self.client.stats())

    def query(self, question: str, slo_class: str = "interactive",
              tenant: str = DEFAULT_TENANT) -> dict:
        from k8s_llm_monitor_tpu_torch.monitor.client import ApiConnectionError

        try:
            return self.client.query(question, slo_class=slo_class,
                                     tenant=tenant)
        except ApiConnectionError as exc:
            raise ReplicaUnavailable(str(exc)) from exc

    def query_stream(self, question: str, slo_class: str = "interactive",
                     tenant: str = DEFAULT_TENANT):
        from k8s_llm_monitor_tpu_torch.monitor.client import ApiConnectionError

        try:
            return self.client.query_stream(question, slo_class=slo_class,
                                            tenant=tenant)
        except ApiConnectionError as exc:
            raise ReplicaUnavailable(str(exc)) from exc

    def analyze(self, payload: dict,
                tenant: str = DEFAULT_TENANT) -> dict:
        from k8s_llm_monitor_tpu_torch.monitor.client import ApiConnectionError

        try:
            return self.client.analyze(payload, tenant=tenant)
        except ApiConnectionError as exc:
            raise ReplicaUnavailable(str(exc)) from exc

    def diagnoses(self, limit: int = 0) -> dict:
        from k8s_llm_monitor_tpu_torch.monitor.client import ApiConnectionError

        try:
            return self.client.diagnoses(limit)
        except ApiConnectionError as exc:
            raise ReplicaUnavailable(str(exc)) from exc

    def fetch_prefix(self, token_ids: list[int],
                     tenant: str = DEFAULT_TENANT):
        from k8s_llm_monitor_tpu_torch.monitor.client import ApiConnectionError

        try:
            return self.client.kv_prefix(token_ids, tenant=tenant)
        except ApiConnectionError as exc:
            raise ReplicaUnavailable(str(exc)) from exc

    def install_prefix(self, blob: bytes,
                       tenant: str | None = None) -> str:
        from k8s_llm_monitor_tpu_torch.monitor.client import ApiConnectionError

        try:
            return self.client.kv_install(blob, tenant=tenant)
        except ApiConnectionError as exc:
            raise ReplicaUnavailable(str(exc)) from exc

    def fetch_trace(self, trace_id: str) -> list[dict]:
        from k8s_llm_monitor_tpu_torch.monitor.client import ApiConnectionError

        try:
            payload = self.client.trace(trace_id)
        except ApiConnectionError:
            return []  # unknown trace / replica down: nothing to merge
        spans = payload.get("spans") if isinstance(payload, dict) else None
        return spans if isinstance(spans, list) else []

    def close(self) -> None:
        self.client.close()
