"""High-level cluster client + wire-shape converters.

Parity target: ``reference/internal/k8s/client.go:35-480`` (read
APIs, CRD upsert) and ``internal/k8s/converter.go:13-111`` (raw object →
model conversion, incl. the non-secret env extraction at converter.go:37-41
and container-state naming at :85-111). The client is backend-agnostic:
pass a ``FakeCluster`` for tests/dev mode or a ``KubeRestBackend`` for a
real cluster.
"""

from __future__ import annotations

import logging
from typing import Any

from k8s_llm_monitor_tpu_torch.monitor.cluster import (
    ClusterBackend,
    ClusterError,
    NotFound,
    WatchStream,
)
from k8s_llm_monitor_tpu_torch.monitor.models import (
    ContainerInfo,
    CustomResourceInfo,
    EventInfo,
    NetworkPolicyInfo,
    NetworkPolicyRule,
    PeerRule,
    PodInfo,
    PortRule,
    ServiceInfo,
    ServicePort,
    UAVReport,
    parse_rfc3339,
    rfc3339,
    utcnow,
)

logger = logging.getLogger("monitor.client")

UAV_METRICS_GVR = ("monitoring.io", "v1", "uavmetrics")
SCHEDULING_GVR = ("scheduler.io", "v1", "schedulingrequests")


# ---------------------------------------------------------------------------
# converters (ref internal/k8s/converter.go)
# ---------------------------------------------------------------------------


def container_state_name(status: dict[str, Any]) -> str:
    """running/waiting:<reason>/terminated:<reason> (ref converter.go:85-111)."""
    state = status.get("state", {})
    if "running" in state:
        return "running"
    if "waiting" in state:
        reason = state["waiting"].get("reason", "")
        return f"waiting:{reason}" if reason else "waiting"
    if "terminated" in state:
        reason = state["terminated"].get("reason", "")
        return f"terminated:{reason}" if reason else "terminated"
    return "unknown"


_SECRET_HINTS = ("PASSWORD", "SECRET", "TOKEN", "KEY", "CREDENTIAL")


def convert_pod(raw: dict[str, Any]) -> PodInfo:
    md = raw.get("metadata", {})
    spec = raw.get("spec", {})
    status = raw.get("status", {})
    statuses = {s.get("name"): s for s in status.get("containerStatuses", [])}
    containers = []
    for c in spec.get("containers", []):
        st = statuses.get(c.get("name"), {})
        env = {}
        for e in c.get("env", []):
            name = e.get("name", "")
            # skip secret-looking and valueFrom-only env (ref converter.go:37-41)
            if "value" not in e:
                continue
            if any(h in name.upper() for h in _SECRET_HINTS):
                continue
            env[name] = e.get("value", "")
        containers.append(
            ContainerInfo(
                name=c.get("name", ""),
                image=c.get("image", ""),
                state=container_state_name(st),
                ready=bool(st.get("ready", False)),
                env=env,
            )
        )
    return PodInfo(
        name=md.get("name", ""),
        namespace=md.get("namespace", ""),
        status=status.get("phase", ""),
        node_name=spec.get("nodeName", ""),
        ip=status.get("podIP", ""),
        labels=dict(md.get("labels", {}) or {}),
        start_time=parse_rfc3339(status.get("startTime")) or utcnow(),
        containers=containers,
    )


def convert_service(raw: dict[str, Any]) -> ServiceInfo:
    md = raw.get("metadata", {})
    spec = raw.get("spec", {})
    return ServiceInfo(
        name=md.get("name", ""),
        namespace=md.get("namespace", ""),
        type=spec.get("type", "ClusterIP"),
        cluster_ip=spec.get("clusterIP", ""),
        ports=[
            ServicePort(
                name=p.get("name", ""),
                port=int(p.get("port", 0)),
                protocol=p.get("protocol", "TCP"),
            )
            for p in spec.get("ports", [])
        ],
        selector=dict(spec.get("selector", {}) or {}),
    )


def convert_event(raw: dict[str, Any]) -> EventInfo:
    ts = (
        raw.get("lastTimestamp")
        or raw.get("eventTime")
        or raw.get("metadata", {}).get("creationTimestamp")
    )
    return EventInfo(
        type=raw.get("type", ""),
        reason=raw.get("reason", ""),
        message=raw.get("message", ""),
        source=raw.get("source", {}).get("component", ""),
        timestamp=parse_rfc3339(ts) or utcnow(),
        count=int(raw.get("count", 1) or 1),
    )


def convert_network_policy(raw: dict[str, Any]) -> NetworkPolicyInfo:
    md = raw.get("metadata", {})
    spec = raw.get("spec", {})

    def peers(items: list[dict]) -> list[PeerRule]:
        return [
            PeerRule(
                pod_selector=dict(
                    (p.get("podSelector") or {}).get("matchLabels", {}) or {}
                ),
                namespace_selector=dict(
                    (p.get("namespaceSelector") or {}).get("matchLabels", {}) or {}
                ),
            )
            for p in items
        ]

    def rules(items: list[dict], peer_key: str) -> list[NetworkPolicyRule]:
        out = []
        for r in items or []:
            rule = NetworkPolicyRule(
                ports=[
                    PortRule(
                        protocol=p.get("protocol", "TCP"), port=int(p.get("port", 0))
                    )
                    for p in r.get("ports", [])
                ]
            )
            if peer_key == "from":
                rule.from_ = peers(r.get("from", []))
            else:
                rule.to = peers(r.get("to", []))
            out.append(rule)
        return out

    return NetworkPolicyInfo(
        name=md.get("name", ""),
        namespace=md.get("namespace", ""),
        pod_selector=dict(
            (spec.get("podSelector") or {}).get("matchLabels", {}) or {}
        ),
        ingress=rules(spec.get("ingress", []), "from"),
        egress=rules(spec.get("egress", []), "to"),
    )


def convert_custom_resource(
    raw: dict[str, Any], group: str, kind: str
) -> CustomResourceInfo:
    """ref client.go convertUnstructuredToModel + getLastUpdateTime."""
    md = raw.get("metadata", {})
    managed = md.get("managedFields") or []
    update_ts = None
    if managed and managed[0].get("time"):
        update_ts = parse_rfc3339(managed[0]["time"])
    creation = parse_rfc3339(md.get("creationTimestamp")) or utcnow()
    return CustomResourceInfo(
        kind=kind,
        name=md.get("name", ""),
        namespace=md.get("namespace", ""),
        group=group,
        version=raw.get("apiVersion", ""),
        spec=dict(raw.get("spec", {}) or {}),
        status=dict(raw.get("status", {}) or {}),
        generation=int(md.get("generation", 0) or 0),
        creation_time=creation,
        update_time=update_ts or creation,
    )


def sanitize_resource_name(name: str) -> str:
    """ref client.go:452-461."""
    name = name.lower().replace("_", "-").replace(".", "-").strip()
    return name or "unknown"


# ---------------------------------------------------------------------------
# client
# ---------------------------------------------------------------------------


class Client:
    """Cluster client over a ``ClusterBackend``.

    Mirrors the reference Client's read API (client.go:103-247) and the
    UAVMetric CRD surface (client.go:255-450).
    """

    def __init__(
        self,
        backend: ClusterBackend,
        namespaces: list[str] | None = None,
        default_namespace: str = "default",
    ) -> None:
        self.backend = backend
        self._namespaces = list(namespaces or [default_namespace])
        self.default_namespace = default_namespace

    # -- basic reads ---------------------------------------------------------

    def namespaces(self) -> list[str]:
        return list(self._namespaces)

    def test_connection(self) -> str:
        version = self.backend.server_version()
        logger.info("Connected to Kubernetes cluster: %s", version)
        return version

    def get_cluster_info(self) -> dict[str, Any]:
        """ref client.go:115-150 — version, node count, pod count, namespaces."""
        version = self.backend.server_version()
        nodes = self.backend.list_nodes()
        pod_count = 0
        for ns in self._namespaces:
            try:
                pod_count += len(self.backend.list_pods(ns))
            except ClusterError as exc:
                logger.warning("Failed to list pods in namespace %s: %s", ns, exc)
        return {
            "version": version,
            "nodes": len(nodes),
            "pods": pod_count,
            "namespaces": list(self._namespaces),
        }

    def get_pods(self, namespace: str) -> list[PodInfo]:
        return [convert_pod(p) for p in self.backend.list_pods(namespace)]

    def get_pod(self, namespace: str, name: str) -> PodInfo:
        for p in self.backend.list_pods(namespace):
            if p.get("metadata", {}).get("name") == name:
                return convert_pod(p)
        raise NotFound(f"pod {namespace}/{name} not found")

    def get_services(self, namespace: str) -> list[ServiceInfo]:
        return [convert_service(s) for s in self.backend.list_services(namespace)]

    def get_events(self, namespace: str, limit: int = 50) -> list[EventInfo]:
        return [
            convert_event(e) for e in self.backend.list_events(namespace, limit=limit)
        ]

    def get_network_policies(self, namespace: str) -> list[NetworkPolicyInfo]:
        return [
            convert_network_policy(p)
            for p in self.backend.list_network_policies(namespace)
        ]

    def get_pod_logs(self, namespace: str, name: str, tail_lines: int = 100) -> str:
        return self.backend.pod_logs(namespace, name, tail_lines=tail_lines)

    def exec_in_pod(
        self, namespace: str, pod: str, command: list[str], timeout: float = 10.0
    ) -> tuple[str, str, int]:
        return self.backend.exec_in_pod(namespace, pod, command, timeout=timeout)

    # -- UAVMetric CRD surface (ref client.go:255-450) ------------------------

    def list_uav_metrics_crd(self, namespace: str = "") -> list[CustomResourceInfo]:
        group, version, plural = UAV_METRICS_GVR
        items = self.backend.list_custom_resources(
            group, version, plural, namespace or None
        )
        return [convert_custom_resource(o, group, "UAVMetric") for o in items]

    def upsert_uav_metric(self, namespace: str, report: UAVReport) -> None:
        """Get-then-create-or-update of ``uavmetric-<node>``.

        Spec/status/label layout matches ref client.go:316-450 so the CRD
        contract (and the scheduler reading it) is wire-compatible.
        """
        if report is None:
            raise ValueError("uav report is None")
        if not report.node_name:
            raise ValueError("uav report missing node name")
        namespace = namespace or self.default_namespace
        group, version, plural = UAV_METRICS_GVR
        name = f"uavmetric-{sanitize_resource_name(report.node_name)}"

        spec: dict[str, Any] = {
            "node_name": report.node_name,
            "uav_id": report.uav_id,
        }
        state = report.state
        if state is not None:
            get = (
                (lambda blk, k, d=0: getattr(getattr(state, blk), k, d))
                if not isinstance(state, dict)
                else (lambda blk, k, d=0: (state.get(blk) or {}).get(k, d))
            )
            spec["gps"] = {
                "latitude": get("gps", "latitude", 0.0),
                "longitude": get("gps", "longitude", 0.0),
                "altitude": get("gps", "altitude", 0.0),
                "relative_altitude": get("gps", "relative_altitude", 0.0),
                "satellite_count": get("gps", "satellite_count", 0),
                "fix_type": get("gps", "fix_type", 0),
            }
            spec["battery"] = {
                "voltage": get("battery", "voltage", 0.0),
                "remaining_percent": get("battery", "remaining_percent", 0.0),
                "remaining_capacity": get("battery", "remaining_capacity", 0.0),
                "temperature": get("battery", "temperature", 0.0),
            }
            spec["flight"] = {
                "mode": get("flight", "mode", ""),
                "armed": get("flight", "armed", False),
                "ground_speed": get("flight", "ground_speed", 0.0),
                "vertical_speed": get("flight", "vertical_speed", 0.0),
            }
            spec["health"] = {
                "system_status": get("health", "system_status", ""),
                "error_count": get("health", "error_count", 0),
                "warning_count": get("health", "warning_count", 0),
            }

        status_payload = {
            "last_update": rfc3339(report.timestamp or utcnow()),
            "collection_status": report.status or "active",
        }
        if report.heartbeat_interval_seconds > 0:
            # Advertised cadence: lets the scheduler judge staleness
            # (monitor/scheduler.py) instead of trusting a frozen
            # "active" status — the reference parses the heartbeat but
            # never uses it (controller.go:202-203, SURVEY §2.7 soft spot).
            status_payload["heartbeat_interval_seconds"] = (
                report.heartbeat_interval_seconds)
        labels: dict[str, Any] = {
            "app": "uav-agent",
            "monitoring.io/component": "uav-metrics",
            "monitoring.io/node": sanitize_resource_name(report.node_name),
        }
        if report.uav_id:
            labels["monitoring.io/uav-id"] = sanitize_resource_name(report.uav_id)
        if report.node_ip:
            labels["monitoring.io/node-ip"] = report.node_ip

        body = {
            "apiVersion": "monitoring.io/v1",
            "kind": "UAVMetric",
            "metadata": {"name": name, "namespace": namespace, "labels": labels},
            "spec": spec,
            "status": status_payload,
        }
        try:
            existing = self.backend.get_custom_resource(
                group, version, plural, namespace, name
            )
        except NotFound:
            self.backend.create_custom_resource(group, version, plural, namespace, body)
            return
        existing["spec"] = spec
        existing["status"] = status_payload
        merged = dict(existing.get("metadata", {}).get("labels", {}) or {})
        merged.update(labels)
        existing.setdefault("metadata", {})["labels"] = merged
        self.backend.update_custom_resource(group, version, plural, namespace, existing)

    # -- watch passthrough ---------------------------------------------------

    def watch(self, kind: str, namespace: str) -> WatchStream:
        return self.backend.watch(kind, namespace)


# ---------------------------------------------------------------------------
# monitor-API client (the server's own HTTP surface)
# ---------------------------------------------------------------------------


class ApiConnectionError(ClusterError):
    """The monitor server could not be reached (or died mid-response).

    Connection-level, not application-level: the replica is a routing
    fact for the fleet tier, which maps this to ``ReplicaUnavailable``.
    """


class ApiClient:
    """HTTP client for the monitor server's own API with the kube_rest
    retry discipline: every socket carries an explicit timeout, GETs
    (probes: ``/readyz``, ``/health``, ``/api/v1/stats``) retry through a
    ``resilience.Backoff`` budget, and POSTs (``/api/v1/query``,
    ``/api/v1/analyze``) are NEVER retried — a query may have side effects
    (admission, generation) and re-dispatch belongs to the fleet router,
    which owns idempotent failover.

    Probe GETs use the short connect timeout (a dead replica must not
    stall the probe loop); query POSTs use the long read timeout, which
    for SSE applies *between* reads so a healthy slow stream is fine.
    """

    # Ceiling on any client-side retry hint, whatever the server says —
    # a misconfigured replica must not park callers for minutes.
    retry_cap_s = 30.0

    def __init__(self, base_url: str, *, connect_timeout_s: float = 2.0,
                 read_timeout_s: float = 30.0, backoff=None):
        import random as _random

        from k8s_llm_monitor_tpu_torch.resilience.retry import Backoff

        self.base_url = base_url.rstrip("/")
        self.connect_timeout_s = connect_timeout_s
        self.read_timeout_s = read_timeout_s
        self.backoff = backoff or Backoff(
            base_s=0.1, cap_s=2.0, attempts=3, rng=_random.Random(0))
        # Decorrelated-jitter state for overload retry hints, per SLO
        # class: consecutive 429s of the same class spread a thundering
        # herd; any successful POST resets the whole map.
        self._retry_rng = _random.Random(1)
        self._retry_prev_s: dict[str, float] = {}

    # -- plumbing ------------------------------------------------------------

    def _url(self, path: str) -> str:
        return f"{self.base_url}{path}"

    def _open(self, path: str, body: dict[str, Any] | None = None,
              timeout: float = 2.0):
        import json as _json
        import urllib.request

        data = None
        headers = self._trace_headers()
        if body is not None:
            data = _json.dumps(body).encode()
            headers["Content-Type"] = "application/json"
        req = urllib.request.Request(self._url(path), data=data,
                                     headers=headers)
        return urllib.request.urlopen(req, timeout=timeout)  # noqa: S310

    @staticmethod
    def _trace_headers() -> dict[str, str]:
        """W3C traceparent for the calling thread's current context, so
        every outbound hop (probes, queries, hedge legs, failover
        replays, KV migration) joins the originating trace."""
        from k8s_llm_monitor_tpu_torch.observability.tracing import get_tracer

        tp = get_tracer().current_traceparent()
        return {"traceparent": tp} if tp else {}

    def _retry_hint_s(self, server_hint_s: float, slo_class: str) -> float:
        """Client-side retry delay from the server's per-class hint:
        decorrelated jitter (``min(cap, uniform(hint, 3 * previous))``),
        so N clients shed in the same step don't all come back on the
        same tick, with ``retry_cap_s`` bounding runaway growth."""
        base = max(0.05, server_hint_s)
        prev = self._retry_prev_s.get(slo_class, base)
        delay = min(self.retry_cap_s,
                    self._retry_rng.uniform(base, max(base, prev * 3.0)))
        self._retry_prev_s[slo_class] = delay
        return delay

    def _overloaded_from(self, exc) -> "OverloadedError | None":
        """Map a 429/503 reply carrying shed evidence to OverloadedError.

        The raised error's ``retry_after_s`` is the server's hint passed
        through :meth:`_retry_hint_s` — NOT a flat fallback — so callers
        that sleep on it honor the replica's per-class pushback."""
        import json as _json

        from k8s_llm_monitor_tpu_torch.resilience.errors import OverloadedError

        if exc.code not in (429, 503):
            return None
        try:
            payload = _json.loads(exc.read().decode())
        except Exception:  # noqa: BLE001 — plain-text 503s exist
            payload = {}
        if exc.code == 503 and payload.get("error_kind") != "overloaded":
            return None
        slo_class = str(payload.get("slo_class", ""))
        try:
            hint = float(payload.get("retry_after_s", 1.0))
        except (TypeError, ValueError):
            hint = 1.0
        return OverloadedError(
            payload.get("reason", f"HTTP {exc.code}"),
            queue_depth=int(payload.get("queue_depth", 0)),
            queue_tokens=int(payload.get("queue_tokens", 0)),
            retriable=exc.code == 429,
            retry_after_s=self._retry_hint_s(hint, slo_class),
            slo_class=slo_class,
            request_id=str(payload.get("request_id", "") or ""),
            tenant=str(payload.get("tenant", "") or ""),
        )

    def _get_json(self, path: str) -> dict[str, Any]:
        """GET with the Backoff retry budget (idempotent: safe to retry)."""
        import json as _json
        import time as _time
        import urllib.error

        delays = list(self.backoff.delays()) + [None]
        last: Exception | None = None
        for delay in delays:
            try:
                with self._open(path, timeout=self.connect_timeout_s) as resp:
                    return _json.loads(resp.read().decode())
            except urllib.error.HTTPError as exc:
                if exc.code < 500:  # the server answered; don't hammer it
                    raise ApiConnectionError(
                        f"GET {path}: HTTP {exc.code}") from exc
                last = exc
            except (urllib.error.URLError, OSError, ValueError) as exc:
                last = exc
            if delay is not None:
                _time.sleep(delay)
        raise ApiConnectionError(f"GET {path}: {last}") from last

    def _post_json(self, path: str, body: dict[str, Any],
                   timeout: float) -> dict[str, Any]:
        """POST, never retried.  4xx/5xx JSON bodies are returned (the
        API ships structured error responses); overload replies raise."""
        import json as _json
        import urllib.error

        try:
            with self._open(path, body=body, timeout=timeout) as resp:
                out = _json.loads(resp.read().decode())
            self._retry_prev_s.clear()  # accepted: end the jitter streak
            return out
        except urllib.error.HTTPError as exc:
            over = self._overloaded_from(exc)
            if over is not None:
                raise over from exc
            try:
                return _json.loads(exc.read().decode())
            except Exception:  # noqa: BLE001
                raise ApiConnectionError(
                    f"POST {path}: HTTP {exc.code}") from exc
        except (urllib.error.URLError, OSError) as exc:
            raise ApiConnectionError(f"POST {path}: {exc}") from exc

    # -- probes (GET, retried) ----------------------------------------------

    def readyz(self) -> bool:
        import urllib.error

        try:
            with self._open("/readyz", timeout=self.connect_timeout_s) as r:
                return r.status == 200
        except urllib.error.HTTPError:
            return False
        except (urllib.error.URLError, OSError) as exc:
            raise ApiConnectionError(f"GET /readyz: {exc}") from exc

    def health(self) -> dict[str, Any]:
        return self._get_json("/health")

    def stats(self) -> dict[str, Any]:
        return self._get_json("/api/v1/stats")

    def diagnoses(self, limit: int = 0) -> dict[str, Any]:
        path = "/api/v1/diagnoses"
        if limit > 0:
            path += f"?limit={int(limit)}"
        return self._get_json(path)

    def trace(self, ref: str) -> dict[str, Any]:
        """GET /api/v1/trace/<ref> — spans for a request or trace id
        (the router's cross-replica merge source)."""
        from urllib.parse import quote

        return self._get_json(f"/api/v1/trace/{quote(ref, safe='')}")

    def traces(self, limit: int = 20) -> dict[str, Any]:
        """GET /api/v1/trace — recent traces in the replica's ring."""
        return self._get_json(f"/api/v1/trace?limit={int(limit)}")

    # -- KV prefix migration (POST, never retried) ---------------------------

    def kv_prefix(self, token_ids: list[int],
                  tenant: str = "") -> bytes | None:
        """POST /api/v1/kv/prefix — framed KV pages for the longest
        cached prefix of ``token_ids`` under ``tenant``'s namespace
        (serving/kv_tier.py blob), or None on a 404 cache miss."""
        import urllib.error

        body: dict[str, Any] = {"token_ids": [int(t) for t in token_ids]}
        if tenant:
            body["tenant"] = tenant
        try:
            with self._open("/api/v1/kv/prefix", body=body,
                            timeout=self.read_timeout_s) as resp:
                return resp.read()
        except urllib.error.HTTPError as exc:
            if exc.code == 404:
                return None
            over = self._overloaded_from(exc)
            if over is not None:
                raise over from exc
            raise ApiConnectionError(
                f"POST /api/v1/kv/prefix: HTTP {exc.code}") from exc
        except (urllib.error.URLError, OSError) as exc:
            raise ApiConnectionError(
                f"POST /api/v1/kv/prefix: {exc}") from exc

    def kv_install(self, blob: bytes, tenant: str | None = None) -> str:
        """POST /api/v1/kv/install — raw blob body; returns the engine's
        outcome string (``installed``/``cached``/``incompatible``/
        ``nospace``/``tenant_mismatch``).  ``tenant`` rides the
        ``X-Tenant-Id`` header (the body is the raw blob) and makes the
        receiver refuse a blob whose header names someone else."""
        import json as _json
        import urllib.error
        import urllib.request

        headers = self._trace_headers()
        headers["Content-Type"] = "application/octet-stream"
        if tenant:
            headers["X-Tenant-Id"] = tenant
        req = urllib.request.Request(
            self._url("/api/v1/kv/install"), data=bytes(blob),
            headers=headers)
        try:
            with urllib.request.urlopen(  # noqa: S310
                    req, timeout=self.read_timeout_s) as resp:
                payload = _json.loads(resp.read().decode())
        except urllib.error.HTTPError as exc:
            over = self._overloaded_from(exc)
            if over is not None:
                raise over from exc
            raise ApiConnectionError(
                f"POST /api/v1/kv/install: HTTP {exc.code}") from exc
        except (urllib.error.URLError, OSError, ValueError) as exc:
            raise ApiConnectionError(
                f"POST /api/v1/kv/install: {exc}") from exc
        return str(payload.get("outcome", "error"))

    # -- queries (POST, never retried) ---------------------------------------

    def query(self, question: str,
              slo_class: str = "", tenant: str = "") -> dict[str, Any]:
        body: dict[str, Any] = {"question": question}
        if slo_class:
            body["slo_class"] = slo_class
        if tenant:
            body["tenant"] = tenant
        return self._post_json("/api/v1/query", body,
                               timeout=self.read_timeout_s)

    def analyze(self, payload: dict[str, Any],
                tenant: str = "") -> dict[str, Any]:
        if tenant:
            payload = dict(payload, tenant=tenant)
        return self._post_json("/api/v1/analyze", payload,
                               timeout=self.read_timeout_s)

    def query_stream(self, question: str, slo_class: str = "",
                     tenant: str = ""):
        """POST /api/v1/query with ``stream: true``; returns
        ``(request_id, model, deltas)`` where ``deltas`` yields answer-text
        chunks.  Mid-stream socket death raises ``ApiConnectionError`` from
        the iterator — the router's failover trigger."""
        import json as _json
        import urllib.error

        body: dict[str, Any] = {"question": question, "stream": True}
        if slo_class:
            body["slo_class"] = slo_class
        if tenant:
            body["tenant"] = tenant
        try:
            resp = self._open("/api/v1/query", body=body,
                              timeout=self.read_timeout_s)
        except urllib.error.HTTPError as exc:
            over = self._overloaded_from(exc)
            if over is not None:
                raise over from exc
            raise ApiConnectionError(
                f"POST /api/v1/query: HTTP {exc.code}") from exc
        except (urllib.error.URLError, OSError) as exc:
            raise ApiConnectionError(f"POST /api/v1/query: {exc}") from exc
        self._retry_prev_s.clear()  # admitted: end the jitter streak

        def events():
            import http.client

            try:
                with resp:
                    for raw in resp:
                        line = raw.decode("utf-8", "replace").strip()
                        if not line.startswith("data: "):
                            continue
                        yield _json.loads(line[len("data: "):])
            except (OSError, ValueError, http.client.HTTPException) as exc:
                # IncompleteRead (a HTTPException, not an OSError) is what
                # a replica death mid-chunk actually raises.
                raise ApiConnectionError(f"stream died: {exc}") from exc

        stream = events()
        first = next(stream, None)
        if first is None:
            raise ApiConnectionError("stream ended before any event")
        request_id = first.get("request_id", "")
        model = first.get("model", "")

        def deltas():
            ev = first
            while ev is not None:
                if ev.get("done"):
                    return
                delta = ev.get("delta", "")
                if delta:
                    yield delta
                ev = next(stream, None)
            # EOF without the done event: the replica died mid-answer but
            # the response ended cleanly.  Surface a dead stream so the
            # caller fails over instead of accepting a truncated answer.
            raise ApiConnectionError("stream ended without done event")

        return request_id, model, deltas()

    def close(self) -> None:  # symmetry with pooled clients; nothing held
        pass
