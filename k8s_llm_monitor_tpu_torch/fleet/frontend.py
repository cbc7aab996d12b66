"""Router-role frontend: the fleet behind the standard monitor HTTP API.

``FleetAnalysis`` duck-types the slice of ``AnalysisEngine`` the HTTP
handlers call (``query`` / ``query_stream`` / ``analyze``), delegating to a
``FleetRouter`` over HTTP replicas instead of a local engine.  A router
process therefore serves the *same* ``/api/v1/query`` and
``/api/v1/analyze`` contract as a replica — clients and dashboards don't
know which tier they're talking to.

It deliberately has no ``backend`` attribute: ``MonitorServer`` discovers a
local engine through ``analysis.backend``, and a router has none — its
health comes from the registry (``analysis.router``), wired into
``health_snapshot`` and the exporter's fleet gauges.
"""

from __future__ import annotations

import logging

from k8s_llm_monitor_tpu_torch.fleet.registry import ReplicaRegistry
from k8s_llm_monitor_tpu_torch.fleet.replica import HTTPReplica
from k8s_llm_monitor_tpu_torch.fleet.router import FleetRouter, HedgeConfig
from k8s_llm_monitor_tpu_torch.monitor.models import (AnalysisRequest,
                                                      AnalysisResponse)
from k8s_llm_monitor_tpu_torch.observability.tracing import get_tracer

logger = logging.getLogger("fleet.frontend")


class FleetAnalysis:
    """AnalysisEngine-shaped facade over a ``FleetRouter``."""

    def __init__(self, router: FleetRouter):
        self.router = router

    @staticmethod
    def _to_response(payload: dict) -> AnalysisResponse:
        """Rehydrate a replica's JSON reply; the timestamp is re-stamped
        locally (the wire value is a string, and callers only log it)."""
        payload = payload or {}
        return AnalysisResponse(
            request_id=str(payload.get("request_id", "")),
            status=str(payload.get("status", "error")),
            result=payload.get("result") or {},
            error=str(payload.get("error", "")),
            error_kind=str(payload.get("error_kind", "")),
        )

    def query(self, question: str, slo_class: str = "interactive",
              tenant: str = "") -> AnalysisResponse:
        # Root (or joined) span for the text path: the replica's HTTP hop
        # inherits this context via the ApiClient traceparent header.
        with get_tracer().span("router.query", attrs={"class": slo_class}):
            return self._to_response(
                self.router.query(question, slo_class=slo_class,
                                  tenant=tenant))

    def query_stream(self, question: str, slo_class: str = "interactive",
                     tenant: str = ""):
        # The span covers dispatch (replica choice + SSE open); streaming
        # itself is consumed by the HTTP handler after this returns.
        with get_tracer().span("router.query_stream",
                               attrs={"class": slo_class}):
            return self.router.query_stream(question, slo_class=slo_class,
                                            tenant=tenant)

    def analyze(self, request: AnalysisRequest,
                tenant: str = "") -> AnalysisResponse:
        return self._to_response(self.router.analyze({
            "type": request.type,
            "parameters": request.parameters,
            "context": request.context,
        }, tenant=tenant))

    def diagnoses(self, limit: int = 0) -> dict:
        """Raw replica payload for GET /api/v1/diagnoses — the handler
        serves it verbatim, so router and replica answer the same shape
        (plus the ``replica`` field saying who answered)."""
        return self.router.diagnoses(limit)

    def close(self) -> None:
        self.router.registry.stop_probes()
        for rid in self.router.registry.ids():
            entry = self.router.registry.get(rid)
            if entry is not None:
                entry.replica.close()


def build_router_server(config, web_dir=None):
    """Wire a router-role ``MonitorServer``: HTTP replica adapters from
    ``config.fleet.replicas`` → registry (+ background probes) → router →
    ``FleetAnalysis`` behind the standard HTTP API.  No cluster client and
    no metrics manager — a router routes; replicas analyze."""
    from k8s_llm_monitor_tpu_torch.monitor.server import MonitorServer

    fcfg = config.fleet
    if not fcfg.replicas:
        raise ValueError(
            "router role needs fleet.replicas (comma-separated URLs via "
            "FLEET_REPLICAS or the fleet: config block)")
    registry = ReplicaRegistry(
        breaker_failures=fcfg.breaker_failures,
        breaker_cooldown_s=fcfg.breaker_cooldown_s)
    for i, url in enumerate(fcfg.replicas):
        registry.add(HTTPReplica(
            f"replica-{i}", url,
            connect_timeout_s=fcfg.connect_timeout_s,
            read_timeout_s=fcfg.read_timeout_s))
    governor = None
    tcfg = getattr(config, "tenancy", None)
    if tcfg is not None and tcfg.enabled:
        from k8s_llm_monitor_tpu_torch.resilience.tenancy import TenantGovernor

        # Fleet tenancy: the router owns the ONE governor for the whole
        # fleet — it admits per logical request before any replica
        # dispatch, so hedges and failover replays can never double-charge
        # (replicas behind this router run with governor=None).
        governor = TenantGovernor(
            requests_per_s=tcfg.requests_per_s,
            request_burst=tcfg.request_burst,
            tokens_per_s=tcfg.tokens_per_s,
            token_burst=tcfg.token_burst,
            enforce=tcfg.enforce,
            max_tenants=tcfg.max_tenants)
    router = FleetRouter(
        registry, policy=fcfg.policy,
        hedge=HedgeConfig(enabled=fcfg.hedge_enabled,
                          min_delay_s=fcfg.hedge_min_delay_s,
                          fixed_delay_s=fcfg.hedge_fixed_delay_s),
        max_failovers=fcfg.max_failovers,
        affinity_prefix_tokens=fcfg.affinity_prefix_tokens,
        batch_spill_threshold=fcfg.batch_spill_threshold,
        drain_sweep_budget=fcfg.drain_sweep_budget,
        governor=governor)
    registry.refresh()
    registry.start_probes(interval_s=fcfg.probe_interval_s)
    logger.info("router fronting %d replica(s), policy=%s, hedging=%s",
                len(registry), fcfg.policy,
                "on" if fcfg.hedge_enabled else "off")
    signals = None
    if config.telemetry.enabled:
        from k8s_llm_monitor_tpu_torch.observability.flight import (
            get_flight_recorder,
        )
        from k8s_llm_monitor_tpu_torch.observability.signals import (
            SignalScraper,
        )

        # Router-role telemetry: fleet-merged series fed by the registry
        # probes (telemetry_sample()), behind GET /api/v1/signals.  A
        # router has no diagnosis pipeline by default — anomalies are
        # still derived and reported; callers wanting self-diagnosis
        # attach a pipeline to both srv.diagnosis and srv.signals.
        signals = SignalScraper(cfg=config.telemetry)
        get_flight_recorder().signal_source = (
            lambda: signals.store.window_snapshot(
                config.telemetry.flight_window_s))
    srv = MonitorServer(
        config=config, analysis=FleetAnalysis(router), web_dir=web_dir,
        signals=signals)
    srv.governor = governor
    if signals is not None:
        signals.attach(srv)
    if config.autoscale.enabled and signals is not None:
        srv.autoscaler = _build_autoscaler(config, registry, signals)
    return srv


def _build_autoscaler(config, registry, signals):
    """Controller over the kube scale executor (StatefulSet /scale through
    the hardened client).  Returns None — autoscaling disabled, router
    unaffected — when no in-cluster credentials exist (dev/bench fleets
    drive a ``LocalPoolExecutor`` directly instead)."""
    from k8s_llm_monitor_tpu_torch.fleet.autoscaler import (
        AutoscaleController, KubeScaleExecutor)
    from k8s_llm_monitor_tpu_torch.monitor.kube_rest import KubeRestBackend

    try:
        backend = KubeRestBackend.in_cluster()
    except Exception as exc:  # noqa: BLE001 — no cluster: no autoscaler
        logger.warning("autoscale.enabled but no cluster credentials "
                       "(%s); elasticity controller disabled", exc)
        return None
    controller = AutoscaleController(
        signals, KubeScaleExecutor(backend, config.autoscale),
        config.autoscale, registry=registry)
    logger.info("elasticity controller armed (interval=%.1fs, dwell=%.0fs, "
                "cooldown=%.0fs)", config.autoscale.interval_s,
                config.autoscale.scale_down_dwell_s,
                config.autoscale.cooldown_s)
    return controller
