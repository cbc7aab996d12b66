"""The HTTP JSON API server over the port's Analysis Engine.

The JAX package's ``monitor/server.py`` for the routes whose handlers this
port serves, with the same response envelopes, status codes and CORS
header: ``/health``, ``/readyz``, ``/api/v1/stats``, the cluster and pod
listings, ``/api/v1/analyze/pod-communication``, ``/api/v1/analyze``,
``/api/v1/query`` (with ``stream`` and ``session_id``),
``/api/v1/diagnoses``, ``/api/v1/trace[/<id>]``, the
``/api/v1/metrics/{cluster,nodes,nodes/<n>,pods,snapshot,network}``
family, the KV prefix migration pair ``/api/v1/kv/prefix`` (a cached
prefix as a KVX1 blob) and ``/api/v1/kv/install`` (serving/kv_tier.py),
``/metrics`` (monitor/exporter.py), ``/debug/profile`` (a
``torch.profiler`` trace, debug-gated), the telemetry plane's
``/api/v1/signals`` and ``/api/v1/timeseries``
(observability/signals.py), ``/api/v1/remediations[/<id>/approve|reject]``
(remediation/executor.py), the UAV routes (``/api/v1/metrics/uav[/<n>]``,
``/api/v1/uav/{report,command}``, ``/api/v1/crd/uav``) and the static web
directory.  ``build_server`` refuses a config that turns on what it does
not serve (an embedding model, ROADMAP A10; the router role, A8) instead
of booting without it.

Stdlib ``ThreadingHTTPServer``: request concurrency is thread-per-
connection, with the engine doing its own continuous batching underneath.
"""

from __future__ import annotations

import json
import logging
import math
import mimetypes
import os
import tempfile
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path
from typing import Any
from urllib.parse import parse_qs, urlparse

from k8s_llm_monitor_tpu_torch.diagnosis.pipeline import DiagnosisPipeline
from k8s_llm_monitor_tpu_torch.diagnosis.session import SessionManager
from k8s_llm_monitor_tpu_torch.monitor.analysis import (
    AnalysisEngine,
    build_backend,
)
from k8s_llm_monitor_tpu_torch.monitor.client import Client
from k8s_llm_monitor_tpu_torch.monitor.cluster import ClusterError, NotFound
from k8s_llm_monitor_tpu_torch.monitor.config import Config
from k8s_llm_monitor_tpu_torch.monitor.manager import Manager
from k8s_llm_monitor_tpu_torch.monitor.models import (
    AnalysisRequest,
    UAVReport,
    parse_rfc3339,
    rfc3339,
    to_jsonable,
    utcnow,
)
from k8s_llm_monitor_tpu_torch.monitor.network import NetworkAnalyzer
from k8s_llm_monitor_tpu_torch.observability.flight import get_flight_recorder
from k8s_llm_monitor_tpu_torch.observability.signals import SignalScraper
from k8s_llm_monitor_tpu_torch.observability.tracing import (
    get_tracer,
    parse_traceparent,
)
from k8s_llm_monitor_tpu_torch.remediation.executor import RemediationEngine
from k8s_llm_monitor_tpu_torch.resilience.errors import OverloadedError
from k8s_llm_monitor_tpu_torch.resilience.slo import normalize_slo_class
from k8s_llm_monitor_tpu_torch.resilience.tenancy import normalize_tenant
from k8s_llm_monitor_tpu_torch.serving.kv_tier import BlobError

logger = logging.getLogger("monitor.server")

VERSION = "1.0.0"
DEFAULT_WEB_DIR = Path(__file__).resolve().parents[2] / "web"


def _now() -> str:
    return rfc3339(utcnow())


class _HTTPServer(ThreadingHTTPServer):
    """``ThreadingHTTPServer`` with a listen backlog sized for bursts.  The
    stdlib's is 5: a burst of simultaneous clients beyond that, arriving
    between two accepts, overflows it and the kernel resets their
    connections."""

    request_queue_size = 128


class MonitorServer:
    """Owns the HTTP server + the wired components.

    Every component is optional (dev mode): handlers degrade exactly like
    the reference when ``client`` / ``manager`` / ``analysis`` is None.
    """

    def __init__(
        self,
        config: Config | None = None,
        client: Client | None = None,
        manager: Manager | None = None,
        analysis: AnalysisEngine | None = None,
        web_dir: str | Path | None = None,
        host: str | None = None,
        port: int | None = None,
        diagnosis=None,
        signals=None,
    ) -> None:
        self.config = config or Config()
        self.client = client
        self.manager = manager
        self.analysis = analysis
        # diagnosis.pipeline.DiagnosisPipeline: the standing watcher -> LLM
        # loop behind GET /api/v1/diagnoses; None in dev mode.
        self.diagnosis = diagnosis
        # observability.signals.SignalScraper: the telemetry plane behind
        # GET /api/v1/signals + /api/v1/timeseries; starts and stops with
        # the HTTP thread.  None in dev mode or telemetry.enabled=false.
        self.signals = signals
        self.web_dir = Path(web_dir) if web_dir else DEFAULT_WEB_DIR
        self.host = host if host is not None else self.config.server.host
        self.port = port if port is not None else self.config.server.port
        # Flipped by graceful shutdown so /api/v1/stats announces draining
        # one probe before the process leaves.
        self.draining = False
        # remediation.executor.RemediationEngine: the diagnosis pipeline's
        # plan stage, wired by build_server behind RemediationConfig.  None
        # in dev mode (no cluster backend) or remediation.enabled=false.
        # Read by /api/v1/remediations, /api/v1/stats and the exporter.
        self.remediation = None
        # resilience.tenancy.TenantGovernor: per-tenant admission quotas,
        # wired by build_server from the backend; None in dev mode or with
        # tenancy.enabled=false.  Read by /api/v1/stats.
        self.governor = None
        self._httpd: ThreadingHTTPServer | None = None
        self._thread: threading.Thread | None = None

    # -- health ----------------------------------------------------------------

    def engine_service(self):
        """The wired EngineService, when a local engine backend is up."""
        backend = getattr(self.analysis, "backend", None)
        return getattr(backend, "service", None)

    def engine_supervisor(self):
        """The EngineSupervisor, when the backend runs in supervised mode."""
        backend = getattr(self.analysis, "backend", None)
        return getattr(backend, "supervisor", None)

    def request_shutdown(self) -> None:
        """Unblock ``serve_forever`` from another thread (signal handlers
        must not call ``httpd.shutdown`` from the serving thread itself:
        it would deadlock)."""
        httpd = self._httpd
        if httpd is not None:
            httpd.shutdown()

    def health_snapshot(self) -> dict[str, Any]:
        """Aggregate live health across the wired components: the body of
        ``/health``.  Dev mode (no engine) is healthy by definition: there
        is nothing to degrade."""
        snap: dict[str, Any] = {
            "status": "healthy",
            "reason": "",
            "ready": True,
            "timestamp": _now(),
            "version": VERSION,
        }
        svc = self.engine_service()
        if svc is not None:
            h = svc.health.snapshot()
            engine = svc.engine
            snap["status"] = h["state"]
            snap["reason"] = h["reason"]
            snap["ready"] = h["ready"]
            snap["engine"] = {
                "queue_depth": engine.queue_depth,
                "active_slots": engine.active_slots,
                "sheds": h["totals"]["sheds"],
                "recent_shed_rate": h["recent"]["shed_rate"],
                "watchdog_trips": engine.watchdog_trips,
                "dispatch_failures": engine.dispatch_failures,
                "consecutive_dispatch_failures":
                    engine.consecutive_dispatch_failures,
                "deadline_expired": engine.deadline_expired,
                "requeues": engine.requeues,
            }
        sup = self.engine_supervisor()
        if sup is not None:
            lc = sup.snapshot()
            snap["lifecycle"] = lc
            # A terminating/rebuilding/failed supervisor must stop traffic
            # even if the engine health state hasn't caught up yet.
            if lc["state"] != "serving":
                snap["ready"] = False
                if not snap["reason"]:
                    snap["reason"] = f"lifecycle state {lc['state']}"
        breaker = getattr(getattr(self.client, "backend", None),
                          "breaker", None)
        if breaker is not None:
            snap["kube_breaker"] = {
                "state": breaker.state,
                "trips": breaker.trips,
                "rejections": breaker.rejections,
            }
        return snap

    def fleet_router(self):
        """The FleetRouter of a router-role process: None here (the router
        role is ROADMAP A8); the signal scraper and the exporter ask."""
        return getattr(self.analysis, "router", None)

    def stats_snapshot(self) -> dict[str, Any]:
        """Load-signal snapshot: the body of ``GET /api/v1/stats``.  The
        ``engine`` block carries the queue backlog, slot occupancy and the
        counters of the engine's mechanisms; ``fleet`` stays None (the
        router role is ROADMAP A8)."""
        snap: dict[str, Any] = {
            "engine": None,
            "fleet": None,
            "timestamp": _now(),
        }
        svc = self.engine_service()
        if svc is not None:
            engine = svc.engine
            pc = engine.prefix_cache
            snap["engine"] = {
                "queue_depth": engine.queue_depth,
                "queue_tokens": engine.queue_tokens,
                "queue_tokens_by_class": engine.queue_tokens_by_class(),
                "brownout": (engine.brownout()
                             if engine.brownout is not None else 0),
                "busy_slots": engine.active_slots,
                "total_slots": engine.ecfg.max_slots,
                "prefix_deferrals": engine.prefix_deferrals,
                "prefix_cache": {
                    "hits": pc.hits,
                    "misses": pc.misses,
                    "evictions": pc.evictions,
                    "entries": len(pc),
                } if pc is not None else None,
                "kv_tier": engine.kv_tier_stats(),
                "admission_headroom_tokens":
                    engine.admission_headroom_tokens(),
                "shed_by_class": dict(svc.shed_count_by_class),
                "ttft_ema_by_class": {
                    k: round(v, 6)
                    for k, v in engine.ttft_ema_by_class.items()},
                "preemptions_by_class": dict(engine.preemptions_by_class),
                "role": self.config.fleet.role,
                "draining": bool(self.draining),
            }
            if engine.mesh is not None:
                # Port-only: how the mesh serves (gloo runs the decode
                # programs eagerly, stated here).
                snap["engine"]["mesh"] = dict(
                    engine.mesh_axes(), backend=engine.mesh.backend,
                    decode_graphs=engine.decode_graphs,
                    tp_overlap=engine.tp_overlap,
                    decode_path=engine.decode_path,
                    prefill_path=engine.prefill_path)
        if self.governor is not None:
            # Per-tenant accounting: admissions, quota refusals, sheds,
            # charged (delivered) tokens, in-flight reservations, and the
            # remaining token quota (-1 = unlimited).
            snap["tenants"] = self.governor.snapshot()
        if self.remediation is not None:
            snap["remediation"] = self.remediation.snapshot()
        return snap

    # -- lifecycle -------------------------------------------------------------

    def start(self) -> None:
        handler = _make_handler(self)
        self._httpd = _HTTPServer((self.host, self.port), handler)
        self.port = self._httpd.server_address[1]  # resolve port 0
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="monitor-http", daemon=True
        )
        self._thread.start()
        if self.diagnosis is not None:
            self.diagnosis.start()
        if self.signals is not None:
            self.signals.start()
        logger.info("monitor server listening on %s:%d", self.host, self.port)

    def stop(self) -> None:
        if self.diagnosis is not None:
            self.diagnosis.stop()
        if self.signals is not None:
            self.signals.stop()
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    def serve_forever(self) -> None:
        if self.diagnosis is not None:
            self.diagnosis.start()
        if self.signals is not None:
            self.signals.start()
        handler = _make_handler(self)
        self._httpd = _HTTPServer((self.host, self.port), handler)
        self.port = self._httpd.server_address[1]
        logger.info("monitor server listening on %s:%d", self.host, self.port)
        try:
            self._httpd.serve_forever()
        except KeyboardInterrupt:
            logger.info("shutting down server...")
            self._httpd.server_close()


# method-name route table, static across requests (bound per request via
# getattr because handler instances are created per connection)
_ROUTES: dict[tuple[str, str], str] = {
    ("GET", "/health"): "h_health",
    ("GET", "/readyz"): "h_readyz",
    ("GET", "/metrics"): "h_prometheus",
    ("POST", "/debug/profile"): "h_profile",
    ("GET", "/api/v1/stats"): "h_stats",
    ("GET", "/api/v1/cluster/status"): "h_cluster_status",
    ("GET", "/api/v1/pods"): "h_pods",
    ("POST", "/api/v1/analyze/pod-communication"): "h_pod_comm",
    ("POST", "/api/v1/analyze"): "h_analyze",
    ("POST", "/api/v1/query"): "h_query",
    ("GET", "/api/v1/diagnoses"): "h_diagnoses",
    ("GET", "/api/v1/remediations"): "h_remediations",
    ("GET", "/api/v1/signals"): "h_signals",
    ("GET", "/api/v1/timeseries"): "h_timeseries",
    ("GET", "/api/v1/trace"): "h_trace_recent",
    ("GET", "/api/v1/metrics/cluster"): "h_metrics_cluster",
    ("GET", "/api/v1/metrics/nodes"): "h_metrics_nodes",
    ("GET", "/api/v1/metrics/pods"): "h_metrics_pods",
    ("GET", "/api/v1/metrics/snapshot"): "h_metrics_snapshot",
    ("GET", "/api/v1/metrics/network"): "h_metrics_network",
    ("GET", "/api/v1/metrics/uav"): "h_metrics_uav",
    ("POST", "/api/v1/uav/report"): "h_uav_report",
    ("POST", "/api/v1/uav/command"): "h_uav_command",
    ("GET", "/api/v1/crd/uav"): "h_uav_crd",
    ("POST", "/api/v1/kv/prefix"): "h_kv_prefix",
    ("POST", "/api/v1/kv/install"): "h_kv_install",
}
_ROUTE_PATHS = {p for _, p in _ROUTES}


def _make_handler(srv: MonitorServer) -> type[BaseHTTPRequestHandler]:
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        # quiet default logging; route through our logger at debug
        def log_message(self, fmt: str, *args: Any) -> None:
            logger.debug("%s %s", self.address_string(), fmt % args)

        # -- plumbing ---------------------------------------------------------

        def _send_json(
            self, payload: Any, status: int = 200, cors: bool = False,
            headers: dict[str, str] | None = None,
        ) -> None:
            body = json.dumps(to_jsonable(payload)).encode()
            self.send_response(status)
            self.send_header("Content-Type", "application/json")
            if cors:
                self.send_header("Access-Control-Allow-Origin", "*")
            for name, value in (headers or {}).items():
                self.send_header(name, value)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _send_overloaded(self, exc: OverloadedError) -> None:
            retry_after = max(1, math.ceil(exc.retry_after_s))
            self._send_json(
                {
                    "status": "error",
                    "error": str(exc),
                    "error_kind": "overloaded",
                    "reason": exc.reason,
                    "retriable": exc.retriable,
                    "retry_after_s": exc.retry_after_s,
                    "queue_depth": exc.queue_depth,
                    "queue_tokens": exc.queue_tokens,
                    "slo_class": exc.slo_class,
                    # Tenant-tagged refusals: a quota 429 names the tenant
                    # it throttled, so client-side balancers back off the
                    # right traffic class (empty for untenanted refusals).
                    "tenant": exc.tenant,
                    # Assigned before the refusal: lets clients join the
                    # 429/503 with traces, logs, and the journal.
                    "request_id": exc.request_id,
                    "timestamp": _now(),
                },
                status=429 if exc.retriable else 503,
                headers={"Retry-After": str(retry_after)},
            )

        def _send_error_text(self, msg: str, status: int) -> None:
            # mirrors Go http.Error: plain text + newline
            body = (msg + "\n").encode()
            self.send_response(status)
            self.send_header("Content-Type", "text/plain; charset=utf-8")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _parse_tenant(self, body: dict[str, Any] | None = None) -> str:
            """Tenant identity at the trust boundary: the ``X-Tenant-Id``
            header wins over the body's ``"tenant"`` key; absent both,
            the default tenant.  Malformed ids raise ValueError — callers
            map it to a 400 before any engine work happens."""
            raw = (self.headers.get("X-Tenant-Id")
                   or (body or {}).get("tenant") or "")
            return normalize_tenant(raw)

        def _read_json(self) -> dict[str, Any]:
            """Parse the body as a JSON object; raises ValueError (which
            json.JSONDecodeError subclasses) for non-JSON and for valid JSON
            that isn't an object — both are the caller's fault (400)."""
            length = int(self.headers.get("Content-Length", 0) or 0)
            raw = self.rfile.read(length) if length else b""
            if not raw:
                return {}
            data = json.loads(raw)
            if not isinstance(data, dict):
                raise ValueError("JSON body must be an object")
            return data

        # -- routing ----------------------------------------------------------

        def do_GET(self) -> None:  # noqa: N802 (stdlib API)
            self._route("GET")

        def do_POST(self) -> None:  # noqa: N802
            self._route("POST")

        def _route(self, method: str) -> None:
            parsed = urlparse(self.path)
            path = parsed.path
            try:
                # Incoming W3C traceparent joins this handler (and every
                # downstream engine/replica call it makes) to the caller's
                # trace.  Requests without one are not traced at the HTTP
                # layer — generation paths start their own trace at
                # admission, and probe/static traffic stays out of the
                # ring.  A malformed header never fails the request.
                parent = parse_traceparent(
                    self.headers.get("traceparent") or "")
                if parent is not None:
                    with get_tracer().span(
                            "http.server", parent=parent,
                            attrs={"method": method, "path": path}):
                        return self._dispatch(method, path)
                return self._dispatch(method, path)
            except BrokenPipeError:
                pass
            except OverloadedError as exc:
                # Admission-control pushback from the engine/supervisor:
                # 429 when retrying this replica can work (shed, rebuild in
                # progress), 503 when it cannot (draining, failed).  Both
                # carry a Retry-After derived from the shed/restart backoff
                # and the queue evidence a client-side balancer needs.
                try:
                    self._send_overloaded(exc)
                except Exception:  # noqa: BLE001
                    pass
            except Exception as exc:  # noqa: BLE001 — server must not die
                logger.exception("handler error for %s %s", method, path)
                try:
                    self._send_error_text(f"Internal server error: {exc}", 500)
                except Exception:  # noqa: BLE001
                    pass


        def _dispatch(self, method: str, path: str) -> None:
            handler_name = _ROUTES.get((method, path))
            if handler_name is not None:
                return getattr(self, handler_name)()
            # prefix routes with a path parameter
            if path.startswith("/api/v1/metrics/nodes/"):
                if method != "GET":
                    return self._send_error_text("Method not allowed", 405)
                return self.h_metrics_node(path[len("/api/v1/metrics/nodes/") :])
            if path.startswith("/api/v1/metrics/uav/"):
                if method != "GET":
                    return self._send_error_text("Method not allowed", 405)
                return self.h_metrics_uav_node(path[len("/api/v1/metrics/uav/") :])
            if path.startswith("/api/v1/trace/"):
                if method != "GET":
                    return self._send_error_text("Method not allowed", 405)
                return self.h_trace(path[len("/api/v1/trace/") :])
            if path.startswith("/api/v1/remediations/"):
                if method != "POST":
                    return self._send_error_text("Method not allowed", 405)
                return self.h_remediation_action(
                    path[len("/api/v1/remediations/") :])
            if path in _ROUTE_PATHS:
                # registered path, wrong method (ref per-handler checks)
                return self._send_error_text("Method not allowed", 405)
            if method == "GET":
                return self.h_static(path)
            return self._send_error_text("404 page not found", 404)

        def h_static(self, path: str) -> None:
            rel = path.lstrip("/") or "index.html"
            base = srv.web_dir.resolve()
            target = (base / rel).resolve()
            if not target.is_relative_to(base) or not target.is_file():
                return self._send_error_text("404 page not found", 404)
            ctype = mimetypes.guess_type(str(target))[0] or "application/octet-stream"
            data = target.read_bytes()
            self.send_response(200)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        # -- handlers ----------------------------------------------------------

        def h_health(self) -> None:
            # Real state, not a literal: DEGRADED still serves (200),
            # DRAINING/UNHEALTHY answer 503 so probes stop routing here.
            snap = srv.health_snapshot()
            self._send_json(snap, status=200 if snap["ready"] else 503)

        def h_readyz(self) -> None:
            """Readiness probe: should this replica receive traffic?"""
            snap = srv.health_snapshot()
            self._send_json(
                {
                    "ready": snap["ready"],
                    "status": snap["status"],
                    "reason": snap["reason"],
                    "timestamp": snap["timestamp"],
                },
                status=200 if snap["ready"] else 503,
            )

        def h_prometheus(self) -> None:
            # Self-observability the reference never had (SURVEY §5.5):
            # engine/manager/device gauges in Prometheus text format.
            # OpenMetrics is Accept-negotiated: that mode adds exemplars
            # (trace ids on latency histogram buckets) and the EOF marker;
            # the default stays plain 0.0.4 text, exemplar-free.
            from k8s_llm_monitor_tpu_torch.monitor.exporter import render_prometheus

            accept = self.headers.get("Accept") or ""
            openmetrics = "application/openmetrics-text" in accept
            body = render_prometheus(srv, openmetrics=openmetrics).encode()
            self.send_response(200)
            self.send_header(
                "Content-Type",
                "application/openmetrics-text; version=1.0.0; charset=utf-8"
                if openmetrics else
                "text/plain; version=0.0.4; charset=utf-8")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def h_profile(self) -> None:
            """Capture a torch.profiler trace (debug mode only): body
            {"seconds": N, "dir": name?} -> {"trace_dir": ...}, the trace
            a Chrome-trace JSON file in that directory.  With
            "decode_phases" the engine's profile_decode_phases() runs after
            the window (an idle engine; a refusal is reported)."""
            if not srv.config.server.debug:
                return self._send_error_text(
                    "profiling requires server.debug=true", 403)
            try:
                body = self._read_json() or {}
            except ValueError:
                return self._send_error_text("Invalid JSON body", 400)
            seconds = min(float(body.get("seconds", 2.0)), 60.0)
            # "dir" is a subdirectory NAME under the trace root, never an
            # arbitrary filesystem path (debug-gated but unauthenticated).
            root = os.path.join(tempfile.gettempdir(),
                                "k8s-llm-monitor-trace")
            sub = str(body.get("dir") or "")
            if sub and (sub != os.path.basename(sub) or sub.startswith(".")):
                return self._send_error_text(
                    "dir must be a plain subdirectory name", 400)
            trace_dir = os.path.join(root, sub) if sub else root
            import time as _time

            import torch
            from torch.profiler import ProfilerActivity, profile

            activities = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(ProfilerActivity.CUDA)
            os.makedirs(trace_dir, exist_ok=True)
            with profile(activities=activities) as prof:
                _time.sleep(seconds)
            prof.export_chrome_trace(os.path.join(
                trace_dir, f"trace-{os.getpid()}-{_time.time_ns()}.json"))
            payload: dict[str, Any] = {
                "trace_dir": trace_dir, "seconds": seconds}
            if body.get("decode_phases"):
                # Refresh the per-phase decode cost split (the
                # engine_decode_* gauges) behind the same debug gate.
                # Requires an idle engine; refusal is reported, not fatal.
                try:
                    payload["decode_phases"] = self._engine_call(
                        lambda e: e.profile_decode_phases())
                except LookupError:
                    payload["decode_phases_error"] = "no local engine"
                except Exception as exc:  # noqa: BLE001 — busy engine
                    payload["decode_phases_error"] = str(exc)
            self._send_json(payload)

        def h_stats(self) -> None:
            """Load signal: engine queue/slot/prefix-cache counters (what
            the fleet router ranks replicas on), fleet state on routers."""
            self._send_json(srv.stats_snapshot())


        def h_trace_recent(self) -> None:
            """Most recent traces in the span ring (id, span count, root
            span name) plus tracer counters — the entry point for picking
            a trace id to fetch in full."""
            query = parse_qs(urlparse(self.path).query)
            try:
                limit = int((query.get("limit", ["20"])[0]) or 20)
            except ValueError:
                return self._send_error_text("limit must be an integer", 400)
            tracer = get_tracer()
            self._send_json({
                "status": "success",
                "traces": tracer.recent(limit),
                "sample_rate": tracer.sample,
                "spans_recorded": tracer.recorded,
                "timestamp": _now(),
            })


        def h_trace(self, ref: str) -> None:
            """One trace by request id or 32-hex trace id, from the local
            span ring."""
            ref = ref.strip().rstrip("/")
            if not ref:
                return self._send_error_text(
                    "trace or request id is required", 400)
            tracer = get_tracer()
            trace_id = tracer.lookup(ref)
            if trace_id is None:
                return self._send_error_text(
                    f"unknown trace or request id: {ref}", 404)
            spans = tracer.spans_for(trace_id)
            self._send_json({
                "status": "success",
                "trace_id": trace_id,
                "spans": spans,
                "n_spans": len(spans),
                "sources": ["local"],
                "timestamp": _now(),
            })

        def h_cluster_status(self) -> None:
            if srv.client is None:
                return self._send_json(
                    {
                        "status": "warning",
                        "message": "K8s client not available - running in development mode",
                        "timestamp": _now(),
                    }
                )
            try:
                info = srv.client.get_cluster_info()
            except ClusterError as exc:
                return self._send_error_text(
                    f"Failed to get cluster info: {exc}", 500
                )
            self._send_json(
                {"status": "success", "cluster_info": info, "timestamp": _now()}
            )

        def h_pods(self) -> None:
            if srv.client is None:
                return self._send_json(
                    {
                        "status": "warning",
                        "message": "K8s client not available - running in development mode",
                        "pods": [],
                        "timestamp": _now(),
                    }
                )
            all_pods = []
            for ns in srv.client.namespaces():
                try:
                    all_pods.extend(srv.client.get_pods(ns))
                except ClusterError as exc:
                    logger.warning("failed to get pods from %s: %s", ns, exc)
            self._send_json(
                {
                    "status": "success",
                    "pods": all_pods,
                    "count": len(all_pods),
                    "timestamp": _now(),
                }
            )

        def h_pod_comm(self) -> None:
            if srv.client is None:
                return self._send_error_text(
                    "K8s client not available - running in development mode", 503
                )
            try:
                body = self._read_json() or {}
            except ValueError:
                return self._send_error_text("Invalid JSON body", 400)
            pod_a, pod_b = body.get("pod_a", ""), body.get("pod_b", "")
            if not pod_a or not pod_b:
                return self._send_error_text("pod_a and pod_b are required", 400)
            try:
                # LLM-augmented when the Analysis Engine is wired; plain
                # rule-based pipeline otherwise (reference behavior)
                if srv.analysis is not None:
                    resp = srv.analysis.analyze(
                        AnalysisRequest(
                            type="pod_communication",
                            parameters={"pod_a": pod_a, "pod_b": pod_b},
                        )
                    )
                    if resp.status != "success":
                        return self._send_error_text(
                            f"Analysis failed: {resp.error}", 500
                        )
                    payload = {
                        "status": "success",
                        "analysis": resp.result.get("analysis"),
                        "llm_diagnosis": resp.result.get("llm_diagnosis"),
                        "model": resp.result.get("model"),
                        "timestamp": _now(),
                    }
                    return self._send_json(payload)
                analysis = NetworkAnalyzer(srv.client).analyze_pod_communication(
                    pod_a, pod_b
                )
            except NotFound as exc:
                return self._send_error_text(f"Analysis failed: {exc}", 500)
            except ClusterError as exc:
                return self._send_error_text(f"Analysis failed: {exc}", 500)
            self._send_json(
                {"status": "success", "analysis": analysis, "timestamp": _now()}
            )

        def h_query(self) -> None:
            if srv.analysis is None:
                return self._send_error_text(
                    "Analysis engine not available - running in development mode",
                    503,
                )
            try:
                body = self._read_json() or {}
            except ValueError:
                return self._send_error_text("Invalid JSON body", 400)
            question = (body.get("question") or "").strip()
            if not question:
                return self._send_error_text("question is required", 400)
            try:
                # Operator-facing queries default to the interactive lane;
                # callers may opt down to "standard" or "batch".
                slo_class = normalize_slo_class(
                    str(body.get("slo_class") or ""), default="interactive")
                tenant = self._parse_tenant(body)
            except ValueError as exc:
                return self._send_error_text(str(exc), 400)
            if body.get("stream"):
                return self._stream_query(question, slo_class, tenant)
            # Multi-turn follow-ups: "session_id" (even "", which mints a
            # new session) pins the conversation to one frozen cluster
            # context whose token prefix replays every turn — PrefixCache
            # hits locally, prefix-affinity in fleet mode.
            if "session_id" in body:
                resp = srv.analysis.query_session(
                    question, str(body.get("session_id") or ""),
                    slo_class=slo_class, tenant=tenant)
            else:
                resp = srv.analysis.query(question, slo_class=slo_class,
                                          tenant=tenant)
            self._send_json(resp, status=200 if resp.status == "success" else 500)

        def h_diagnoses(self) -> None:
            """Verdict history from the standing diagnosis pipeline."""
            query = parse_qs(urlparse(self.path).query)
            try:
                limit = int((query.get("limit", ["0"])[0]) or 0)
            except ValueError:
                return self._send_error_text("limit must be an integer", 400)
            pipe = srv.diagnosis
            if pipe is not None:
                return self._send_json({
                    "status": "success",
                    "diagnoses": pipe.store.snapshot(limit),
                    "count": len(pipe.store),
                    "verdicts_total": pipe.store.counts(),
                    "pipeline": {
                        "triggers": pipe.triggers_total,
                        "queries": pipe.queries_total,
                        "errors": pipe.errors_total,
                        "lag_ms": pipe.store.lag_ms(),
                        "pending_events": pipe.detector.pending(),
                        "context_events": len(pipe.context),
                    },
                    "timestamp": _now(),
                })
            return self._send_error_text(
                "Diagnosis pipeline not available - running in development "
                "mode", 503)


        def h_remediations(self) -> None:
            """Stored action plans from the remediation engine, newest
            first, plus the outcome counters the exporter renders."""
            rem = srv.remediation
            if rem is None:
                return self._send_error_text(
                    "Remediation engine not available - running without a "
                    "cluster backend or remediation.enabled=false", 503)
            query = parse_qs(urlparse(self.path).query)
            try:
                limit = int((query.get("limit", ["0"])[0]) or 0)
            except ValueError:
                return self._send_error_text("limit must be an integer", 400)
            self._send_json({
                "status": "success",
                "remediations": rem.records(limit),
                "counters": rem.snapshot(),
                "timestamp": _now(),
            })

        def h_remediation_action(self, rest: str) -> None:
            """Per-plan approval path: ``<id>/approve`` executes the plan
            (the operator saying "do it" — this clears the destructive-verb
            gate for that one plan, even in observe-only mode);
            ``<id>/reject`` parks it."""
            rem = srv.remediation
            if rem is None:
                return self._send_error_text(
                    "Remediation engine not available", 503)
            rec_id, _, action = rest.partition("/")
            if action not in ("approve", "reject") or not rec_id:
                return self._send_error_text(
                    "use /api/v1/remediations/<id>/approve or .../reject",
                    404)
            rec = (rem.approve(rec_id) if action == "approve"
                   else rem.reject(rec_id))
            if rec is None:
                return self._send_error_text(
                    f"remediation {rec_id} not found", 404)
            self._send_json({
                "status": "success",
                "action": action,
                "remediation": rec,
                "timestamp": _now(),
            })

        def h_signals(self) -> None:
            """Derived autoscaler/anomaly signals from the telemetry
            plane: fleet-merged per-replica blocks on routers, the local
            engine block on replicas.  ``?window=N`` overrides the
            trailing window (seconds)."""
            scraper = srv.signals
            if scraper is None:
                return self._send_error_text(
                    "Signal scraper not available - running in "
                    "development mode", 503)
            query = parse_qs(urlparse(self.path).query)
            window = None
            raw = (query.get("window", [""])[0] or "").strip()
            if raw:
                try:
                    window = float(raw)
                except ValueError:
                    return self._send_error_text(
                        "window must be a number of seconds", 400)
                if window <= 0:
                    return self._send_error_text(
                        "window must be positive", 400)
            payload = scraper.signals(window_s=window)
            payload["status"] = "success"
            payload["timestamp"] = _now()
            self._send_json(payload)

        def h_timeseries(self) -> None:
            """Raw points of one series family for dashboards:
            ``?name=<series>&window=N`` plus any further query params as
            label equality filters (e.g. ``&replica=replica-0``)."""
            scraper = srv.signals
            if scraper is None:
                return self._send_error_text(
                    "Signal scraper not available - running in "
                    "development mode", 503)
            query = parse_qs(urlparse(self.path).query)
            name = (query.get("name", [""])[0] or "").strip()
            if not name:
                return self._send_error_text("name is required", 400)
            window = scraper.cfg.window_s
            raw = (query.get("window", [""])[0] or "").strip()
            if raw:
                try:
                    window = float(raw)
                except ValueError:
                    return self._send_error_text(
                        "window must be a number of seconds", 400)
            labels = {k: v[0] for k, v in query.items()
                      if k not in ("name", "window") and v}
            series = scraper.store.export(
                name, window_s=window, label_filter=labels or None)
            self._send_json({
                "status": "success",
                "name": name,
                "window_s": window,
                "series": series,
                "n_series": len(series),
                "timestamp": _now(),
            })

        def _stream_query(self, question: str,
                          slo_class: str = "interactive",
                          tenant: str = "") -> None:
            """Server-sent events: one `data:` JSON per answer-text delta as
            tokens come off the device, then a final done event.  TTFT is
            real for clients here — the first delta arrives while the rest
            of the answer is still decoding."""
            try:
                request_id, model, chunks = srv.analysis.query_stream(
                    question, slo_class=slo_class, tenant=tenant)
            except OverloadedError as exc:  # headers not sent yet: 429/503
                return self._send_overloaded(exc)
            except Exception as exc:  # noqa: BLE001 — before headers: 500
                return self._send_error_text(f"query failed: {exc}", 500)
            self.send_response(200)
            self.send_header("Content-Type", "text/event-stream")
            self.send_header("Cache-Control", "no-cache")
            self.send_header("Transfer-Encoding", "chunked")
            self.end_headers()

            def event(payload: dict[str, Any]) -> None:
                data = f"data: {json.dumps(payload)}\n\n".encode()
                self.wfile.write(f"{len(data):x}\r\n".encode() + data + b"\r\n")
                self.wfile.flush()

            try:
                for chunk in chunks:
                    event({"request_id": request_id, "delta": chunk})
                event({"request_id": request_id, "done": True, "model": model})
            except BrokenPipeError:
                # Client went away mid-stream: close the generator so the
                # backend cancels the in-flight generation.
                if hasattr(chunks, "close"):
                    chunks.close()
                return
            except Exception as exc:  # noqa: BLE001 — headers already sent
                try:
                    event({"request_id": request_id, "error": str(exc)})
                except BrokenPipeError:
                    return
            try:
                self.wfile.write(b"0\r\n\r\n")
                self.wfile.flush()
            except BrokenPipeError:
                pass

        def h_analyze(self) -> None:
            if srv.analysis is None:
                return self._send_error_text(
                    "Analysis engine not available - running in development mode",
                    503,
                )
            try:
                body = self._read_json() or {}
            except ValueError:
                return self._send_error_text("Invalid JSON body", 400)
            try:
                tenant = self._parse_tenant(body)
            except ValueError as exc:
                return self._send_error_text(str(exc), 400)
            req = AnalysisRequest(
                type=body.get("type", ""),
                parameters=body.get("parameters") or {},
                context=body.get("context") or {},
            )
            resp = srv.analysis.analyze(req, tenant=tenant)
            if resp.status == "success":
                return self._send_json(resp)
            # validation errors are the caller's fault; everything else is a
            # server-side failure monitoring clients should retry on
            self._send_json(resp, status=400 if resp.error_kind == "validation" else 500)

        # -- KV prefix migration (serving/kv_tier.py blob framing) --------------

        def _engine_call(self, fn):
            """Run ``fn(engine)`` on the step thread via the supervisor's
            (preferred) or service's ``call`` seam; None when this role
            runs no local engine."""
            sup = srv.engine_supervisor()
            if sup is not None:
                return sup.call(fn)
            svc = srv.engine_service()
            if svc is None:
                raise LookupError("no local engine")
            return svc.call(fn)

        def h_kv_prefix(self) -> None:
            """Page-fetch endpoint: body ``{"token_ids": [...]}`` ->
            framed KV blob (octet-stream) for the longest cached prefix,
            or 404 on a cache miss.  The fleet router's migration path
            calls this on the prefix-affinity owner."""
            try:
                body = self._read_json() or {}
            except ValueError:
                return self._send_error_text("Invalid JSON body", 400)
            ids = body.get("token_ids")
            if (not isinstance(ids, list) or not ids
                    or not all(isinstance(t, int) for t in ids)):
                return self._send_error_text(
                    "token_ids must be a non-empty list of ints", 400)
            try:
                tenant = self._parse_tenant(body)
            except ValueError as exc:
                return self._send_error_text(str(exc), 400)
            try:
                blob = self._engine_call(
                    lambda e: e.export_prefix([int(t) for t in ids],
                                              tenant=tenant))
            except LookupError:
                return self._send_error_text(
                    "Engine not available - running in development mode",
                    503)
            if blob is None:
                return self._send_error_text("no cached prefix", 404)
            self.send_response(200)
            self.send_header("Content-Type", "application/octet-stream")
            self.send_header("Content-Length", str(len(blob)))
            self.end_headers()
            self.wfile.write(blob)

        def h_kv_install(self) -> None:
            """Install a fetched prefix blob (raw octet-stream body) into
            the local KV pool; responds with the engine's outcome string
            (``installed``/``cached``/``incompatible``/``nospace``/
            ``tenant_mismatch``).  The body is the raw blob, so tenant
            identity rides only on the ``X-Tenant-Id`` header: when set,
            a blob packed under a different tenant's namespace is refused
            as ``tenant_mismatch``; absent, the blob's own header rules.
            Framing/CRC damage is the sender's fault: 400."""
            raw_tenant = self.headers.get("X-Tenant-Id") or ""
            try:
                expected = (normalize_tenant(raw_tenant)
                            if raw_tenant else None)
            except ValueError as exc:
                return self._send_error_text(str(exc), 400)
            length = int(self.headers.get("Content-Length", 0) or 0)
            blob = self.rfile.read(length) if length else b""
            if not blob:
                return self._send_error_text("empty blob", 400)
            try:
                outcome = self._engine_call(
                    lambda e: e.install_prefix(blob,
                                               expected_tenant=expected))
            except LookupError:
                return self._send_error_text(
                    "Engine not available - running in development mode",
                    503)
            except BlobError as exc:
                return self._send_error_text(f"bad blob: {exc}", 400)
            self._send_json({"status": "success", "outcome": outcome,
                             "timestamp": _now()})

        # -- metrics handlers (CORS like ref :328) ------------------------------

        def _need_manager(self) -> bool:
            if srv.manager is None:
                self._send_error_text("Metrics manager not available", 503)
                return False
            return True

        def h_metrics_cluster(self) -> None:
            if not self._need_manager():
                return
            self._send_json(
                {
                    "status": "success",
                    "data": srv.manager.get_cluster_metrics(),
                    "timestamp": _now(),
                },
                cors=True,
            )

        def h_metrics_nodes(self) -> None:
            if not self._need_manager():
                return
            snap = srv.manager.get_latest_snapshot()
            self._send_json(
                {
                    "status": "success",
                    "data": snap.node_metrics,
                    "count": len(snap.node_metrics),
                    "timestamp": rfc3339(snap.timestamp),
                },
                cors=True,
            )

        def h_metrics_node(self, node_name: str) -> None:
            if not self._need_manager():
                return
            if not node_name:
                return self._send_error_text("Node name is required", 400)
            try:
                node = srv.manager.get_node_metrics(node_name)
            except KeyError as exc:
                return self._send_error_text(f"Node not found: {exc}", 404)
            self._send_json(
                {"status": "success", "data": node, "timestamp": _now()}, cors=True
            )

        def h_metrics_pods(self) -> None:
            if not self._need_manager():
                return
            snap = srv.manager.get_latest_snapshot()
            self._send_json(
                {
                    "status": "success",
                    "data": snap.pod_metrics,
                    "count": len(snap.pod_metrics),
                    "timestamp": rfc3339(snap.timestamp),
                },
                cors=True,
            )

        def h_metrics_snapshot(self) -> None:
            if not self._need_manager():
                return
            self._send_json(
                {"status": "success", "data": srv.manager.get_latest_snapshot()},
                cors=True,
            )

        def h_metrics_network(self) -> None:
            if not self._need_manager():
                return
            nets = srv.manager.get_network_metrics()
            self._send_json(
                {
                    "status": "success",
                    "data": nets,
                    "count": len(nets),
                    "timestamp": _now(),
                },
                cors=True,
            )



        def h_metrics_uav(self) -> None:
            if not self._need_manager():
                return
            uavs = srv.manager.get_uav_metrics()
            self._send_json(
                {
                    "status": "success",
                    "data": uavs,
                    "count": len(uavs),
                    "timestamp": _now(),
                },
                cors=True,
            )

        def h_metrics_uav_node(self, node_name: str) -> None:
            if not self._need_manager():
                return
            if not node_name:
                return self._send_error_text("Node name is required", 400)
            entry = srv.manager.get_single_uav_metrics(node_name)
            if entry is None:
                return self._send_error_text(
                    f"UAV not found on node: {node_name}", 404
                )
            self._send_json(
                {"status": "success", "data": entry, "timestamp": _now()}, cors=True
            )

        def h_uav_command(self) -> None:
            """Push a flight command to a node's UAV agent — the server-side
            surface the reference's SendCommandToUAV lacked (its payload
            marshaling was an unfinished TODO, ref uav_metrics.go:254-266,
            and no HTTP route ever called it)."""
            if srv.manager is None:
                return self._send_json(
                    {"status": "warning",
                     "message": "Metrics manager not available - running "
                                "in development mode"},
                    503,
                )
            try:
                body = self._read_json() or {}
            except ValueError:
                return self._send_error_text("Invalid JSON body", 400)
            node = body.get("node", "")
            command = body.get("command", "")
            if not node or not command:
                return self._send_error_text("node and command are required", 400)
            if command not in ("arm", "disarm", "takeoff", "land", "rtl", "mode"):
                return self._send_error_text(
                    f"unknown command {command!r}", 400)
            if srv.manager.uav_source is None:
                return self._send_error_text(
                    "UAV metrics source is disabled", 503)
            try:
                result = srv.manager.send_uav_command(
                    node, command, body.get("params") or {})
            except ValueError as exc:
                return self._send_error_text(str(exc), 404)
            except Exception as exc:  # noqa: BLE001 — agent unreachable
                return self._send_error_text(f"command failed: {exc}", 502)
            self._send_json({"status": "success", "node": node,
                             "command": command, "agent_response": result})

        def h_uav_report(self) -> None:
            try:
                body = self._read_json() or {}
            except ValueError:
                return self._send_error_text("Invalid JSON body", 400)
            node_name = body.get("node_name", "")
            if not node_name:
                return self._send_error_text("node_name is required", 400)
            try:
                heartbeat = int(body.get("heartbeat_interval_seconds", 0) or 0)
            except (TypeError, ValueError):
                return self._send_error_text(
                    "heartbeat_interval_seconds must be a number", 400
                )
            report = UAVReport(
                node_name=node_name,
                node_ip=body.get("node_ip", ""),
                uav_id=body.get("uav_id") or f"uav-{node_name}",
                source=body.get("source") or "agent",
                status=body.get("status") or "active",
                timestamp=parse_rfc3339(body.get("timestamp")) or utcnow(),
                heartbeat_interval_seconds=heartbeat,
                state=body.get("state"),
                metadata=body.get("metadata") or {},
            )
            if srv.manager is not None:
                srv.manager.update_uav_report(report)
            else:
                logger.warning(
                    "metrics manager unavailable, skipping cache update for %s",
                    node_name,
                )
            crd_status, crd_error = "unavailable", ""
            if srv.client is not None:
                try:
                    srv.client.upsert_uav_metric("", report)
                    crd_status = "updated"
                except (ClusterError, ValueError) as exc:
                    logger.warning("UAVMetric upsert failed for %s: %s", node_name, exc)
                    crd_status, crd_error = "error", str(exc)
            payload: dict[str, Any] = {
                "status": "success",
                "crd_status": crd_status,
                "timestamp": _now(),
                "node_name": report.node_name,
                "uav_id": report.uav_id,
                "uav_status": report.status,
            }
            if report.heartbeat_interval_seconds > 0:
                payload["heartbeat_interval_seconds"] = (
                    report.heartbeat_interval_seconds
                )
            if crd_error:
                payload["message"] = crd_error
            self._send_json(payload, cors=True)

        def h_uav_crd(self) -> None:
            if srv.client is None:
                return self._send_json(
                    {"status": "error", "message": "K8s client not available"},
                    status=503,
                    cors=True,
                )
            query = parse_qs(urlparse(self.path).query)
            namespace = (query.get("namespace", [""])[0] or "").strip()
            if namespace.lower() == "all":
                namespace = ""
            try:
                data = srv.client.list_uav_metrics_crd(namespace)
            except ClusterError as exc:
                logger.warning("failed to list UAV CRD data: %s", exc)
                return self._send_json(
                    {"status": "error", "message": str(exc)}, status=500, cors=True
                )
            self._send_json(
                {
                    "status": "success",
                    "count": len(data),
                    "data": data,
                    "timestamp": _now(),
                },
                cors=True,
            )

    return Handler


def _refuse_unported(config: Config) -> None:
    """Raise ``NotImplementedError`` for a config that turns on a server
    piece this port does not have yet, naming its ROADMAP item, before any
    model is built."""
    if config.analysis.embedding_model:
        raise NotImplementedError(
            f"analysis.embedding_model={config.analysis.embedding_model!r}: "
            "the embedding anomaly detector is not ported (ROADMAP A10)")
    if config.fleet.role == "router":
        raise NotImplementedError(
            "fleet.role='router': the fleet router is not ported "
            "(ROADMAP A8)")


def build_server(
    config: Config,
    backend=None,
    web_dir: str | Path | None = None,
    uav_fetcher=None,
    *,
    device=None,
    mesh_backend: str = "nccl",
) -> MonitorServer:
    """Wire the full server from config: cluster backend -> client ->
    manager -> analysis engine -> HTTP.  ``backend=None`` boots dev mode (no
    cluster), like the reference's nil-client path.  With
    ``llm.provider="tpu"`` the model is built on ``device``: ``cuda``
    unless the caller asks for the CPU; an ``llm.tpu.mesh_shape`` mesh runs
    its collectives on ``mesh_backend`` (parallel/mesh.py)."""
    _refuse_unported(config)
    client = None
    manager = None
    if backend is not None:
        client = Client(
            backend,
            namespaces=config.k8s.watch_namespaces,
            default_namespace=config.k8s.namespace,
        )
        try:
            client.test_connection()
        except ClusterError as exc:
            logger.warning(
                "cluster unreachable (%s) - running in development mode", exc
            )
            client = None
    if client is not None and config.metrics.enabled:
        manager = Manager(client, config.metrics, uav_fetcher=uav_fetcher)
    llm_backend = build_backend(config.llm, lifecycle=config.lifecycle,
                                tenancy=config.tenancy, device=device,
                                mesh_backend=mesh_backend)
    analysis = AnalysisEngine(
        llm_backend,
        client=client,
        manager=manager,
        cfg=config.analysis,
        llm_cfg=config.llm,
    )
    analysis.sessions = SessionManager(
        ttl_s=config.diagnosis.session_ttl_s,
        max_sessions=config.diagnosis.max_sessions,
    )
    diagnosis = None
    if config.diagnosis.enabled:
        # Constructed here; its worker thread starts with the HTTP server
        # (start()/serve_forever()), and the Watcher feeding it is wired by
        # cmd/server.py, which owns thread lifecycles.
        # Brownout coupling: at DRAINING the pipeline pauses new triggers
        # (the backend exposes the rung only when it runs a local engine).
        brownout = getattr(llm_backend, "brownout_level", None)
        diagnosis = DiagnosisPipeline(analysis, config.diagnosis,
                                      brownout=brownout)
    signals = None
    if config.telemetry.enabled:
        # Anomaly flags feed the diagnosis pipeline's event ring as
        # synthetic self_monitor Warnings: the monitor diagnoses its own
        # serving stack.
        signals = SignalScraper(cfg=config.telemetry, pipeline=diagnosis)
    srv = MonitorServer(
        config=config,
        client=client,
        manager=manager,
        analysis=analysis,
        web_dir=web_dir,
        diagnosis=diagnosis,
        signals=signals,
    )
    # Single-replica tenancy: the backend's governor (None for remote/
    # template backends or tenancy.enabled=false) feeds /api/v1/stats.
    srv.governor = getattr(llm_backend, "governor", None)
    # Closed-loop remediation: the pipeline's plan stage.  Needs both a
    # cluster backend (targets are enumerated from live state) and the
    # diagnosis pipeline (verdicts are the input); observe-only unless
    # config.remediation.execute or a per-plan approval says otherwise.
    if (config.remediation.enabled and backend is not None
            and diagnosis is not None):
        remediation = RemediationEngine(
            backend, analysis, config.remediation,
            namespaces=tuple(config.k8s.watch_namespaces),
            pipeline=diagnosis,
        )
        diagnosis.remediation = remediation
        srv.remediation = remediation
    if signals is not None:
        signals.attach(srv)
        # Crash-edge dumps (the flight recorder) carry the trailing signal
        # window: the load trajectory into the failure.
        get_flight_recorder().signal_source = (
            lambda: signals.store.window_snapshot(
                config.telemetry.flight_window_s))
    return srv
