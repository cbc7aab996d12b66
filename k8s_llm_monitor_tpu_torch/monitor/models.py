"""Cluster data models — the JSON API contract.

Parity target: ``reference/pkg/models/models.go`` (PodInfo …
UAVReport, models.go:10-192) and ``pkg/models/scheduler.go:6-38``. Field
names here ARE the wire names (the Go structs' json tags), so
``to_jsonable`` needs no renaming map. Timestamps serialize as RFC3339 UTC,
matching Go ``time.Time`` marshaling.
"""

from __future__ import annotations

import dataclasses
import re
from dataclasses import dataclass, field
from datetime import datetime, timezone
from typing import Any

# ---------------------------------------------------------------------------
# serialization helpers
# ---------------------------------------------------------------------------

EPOCH = datetime(1, 1, 1, tzinfo=timezone.utc)  # Go zero time


def utcnow() -> datetime:
    return datetime.now(timezone.utc)


def rfc3339(ts: datetime | None) -> str:
    """Format like Go time.Time JSON marshaling (RFC3339, Z suffix)."""
    if ts is None:
        ts = EPOCH
    if ts.tzinfo is None:
        ts = ts.replace(tzinfo=timezone.utc)
    ts = ts.astimezone(timezone.utc)
    if ts.microsecond:
        return ts.strftime("%Y-%m-%dT%H:%M:%S.%f").rstrip("0") + "Z"
    return ts.strftime("%Y-%m-%dT%H:%M:%SZ")


_FRACTION = re.compile(r"\.(\d+)")


def parse_rfc3339(s: str | None) -> datetime | None:
    if not s:
        return None
    s = s.replace("Z", "+00:00")
    # RFC3339 allows any fractional-second width (Go's marshaler strips
    # trailing zeros; k8s emits nanoseconds), but fromisoformat on
    # Python < 3.11 accepts only exactly 3 or 6 digits — normalize to 6.
    m = _FRACTION.search(s)
    if m:
        s = f"{s[:m.start()]}.{m.group(1)[:6]:0<6}{s[m.end():]}"
    try:
        return datetime.fromisoformat(s)
    except ValueError:
        return None


def to_jsonable(obj: Any) -> Any:
    """Dataclass tree → JSON-ready plain structures.

    Honors per-field ``metadata={"omitempty": True}`` the way Go's
    ``json:",omitempty"`` does (drop zero values).
    """
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        out: dict[str, Any] = {}
        for f in dataclasses.fields(obj):
            val = getattr(obj, f.name)
            if f.metadata.get("omitempty") and not val:
                continue
            out[f.metadata.get("name", f.name)] = to_jsonable(val)
        return out
    if isinstance(obj, datetime):
        return rfc3339(obj)
    if isinstance(obj, dict):
        return {k: to_jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [to_jsonable(v) for v in obj]
    return obj


def omitempty() -> dict[str, bool]:
    return {"omitempty": True}


# ---------------------------------------------------------------------------
# core resource models (ref pkg/models/models.go:10-83)
# ---------------------------------------------------------------------------


@dataclass
class ContainerInfo:
    name: str = ""
    image: str = ""
    state: str = ""
    ready: bool = False
    env: dict[str, str] = field(default_factory=dict)


@dataclass
class PodInfo:
    name: str = ""
    namespace: str = ""
    status: str = ""
    node_name: str = ""
    ip: str = ""
    labels: dict[str, str] = field(default_factory=dict)
    start_time: datetime = field(default_factory=utcnow)
    containers: list[ContainerInfo] = field(default_factory=list)


@dataclass
class ServicePort:
    name: str = ""
    port: int = 0
    protocol: str = "TCP"


@dataclass
class ServiceInfo:
    name: str = ""
    namespace: str = ""
    type: str = "ClusterIP"
    cluster_ip: str = ""
    ports: list[ServicePort] = field(default_factory=list)
    selector: dict[str, str] = field(default_factory=dict)


@dataclass
class EventInfo:
    type: str = ""
    reason: str = ""
    message: str = ""
    source: str = ""
    timestamp: datetime = field(default_factory=utcnow)
    count: int = 0


@dataclass
class PortRule:
    protocol: str = "TCP"
    port: int = 0


@dataclass
class PeerRule:
    pod_selector: dict[str, str] = field(default_factory=dict)
    namespace_selector: dict[str, str] = field(default_factory=dict)


@dataclass
class NetworkPolicyRule:
    ports: list[PortRule] = field(default_factory=list)
    # 'from' is a Python keyword; the metadata name restores the wire key.
    from_: list[PeerRule] = field(default_factory=list, metadata={"name": "from"})
    to: list[PeerRule] = field(default_factory=list)


@dataclass
class NetworkPolicyInfo:
    name: str = ""
    namespace: str = ""
    pod_selector: dict[str, str] = field(default_factory=dict)
    ingress: list[NetworkPolicyRule] = field(default_factory=list)
    egress: list[NetworkPolicyRule] = field(default_factory=list)


# ---------------------------------------------------------------------------
# analysis models (ref pkg/models/models.go:85-118)
# ---------------------------------------------------------------------------

ANALYSIS_TYPES = ("pod_communication", "anomaly_detection", "root_cause")


@dataclass
class AnalysisRequest:
    type: str = ""
    parameters: dict[str, Any] = field(default_factory=dict)
    context: dict[str, Any] = field(default_factory=dict)


@dataclass
class AnalysisResponse:
    request_id: str = ""
    status: str = ""  # success | error | processing
    result: dict[str, Any] = field(default_factory=dict)
    error: str = field(default="", metadata=omitempty())
    # "validation" (caller's request is bad) vs "internal" (server-side
    # failure) — lets the API layer pick 4xx vs 5xx correctly
    error_kind: str = field(default="", metadata=omitempty())
    timestamp: datetime = field(default_factory=utcnow)


@dataclass
class CommunicationAnalysis:
    pod_a: str = ""
    pod_b: str = ""
    status: str = "unknown"  # connected | disconnected | unknown
    issues: list[str] = field(default_factory=list)
    solutions: list[str] = field(default_factory=list)
    confidence: float = 0.0


@dataclass
class SystemHealth:
    overall_health: str = ""
    components: dict[str, Any] = field(default_factory=dict)
    issues: list[str] = field(default_factory=list)
    suggestions: list[str] = field(default_factory=list)
    last_update: datetime = field(default_factory=utcnow)


# ---------------------------------------------------------------------------
# CRD models (ref pkg/models/models.go:120-158)
# ---------------------------------------------------------------------------


@dataclass
class CRDInfo:
    name: str = ""
    group: str = ""
    kind: str = ""
    scope: str = "Namespaced"  # Cluster | Namespaced
    versions: list[str] = field(default_factory=list)
    plural: str = ""
    singular: str = ""
    established: bool = False
    stored: bool = False
    creation_time: datetime = field(default_factory=utcnow)


@dataclass
class CustomResourceInfo:
    kind: str = ""
    name: str = ""
    namespace: str = ""
    group: str = ""
    version: str = ""
    spec: dict[str, Any] = field(default_factory=dict)
    status: dict[str, Any] = field(default_factory=dict)
    generation: int = 0
    creation_time: datetime = field(default_factory=utcnow)
    update_time: datetime = field(default_factory=utcnow)


@dataclass
class CRDEvent:
    type: str = ""  # Added | Modified | Deleted
    kind: str = ""
    group: str = ""
    version: str = ""
    name: str = ""
    namespace: str = ""
    object: dict[str, Any] = field(default_factory=dict)
    timestamp: datetime = field(default_factory=utcnow)


# ---------------------------------------------------------------------------
# network test models (ref pkg/models/models.go:160-179)
# ---------------------------------------------------------------------------


@dataclass
class RTTResult:
    success: bool = False
    rtt_ms: float = 0.0
    packet_loss: float = 0.0
    error_message: str = ""
    timestamp: datetime = field(default_factory=utcnow)
    method: str = ""  # ping | http | ...


@dataclass
class NetworkTestResult:
    pod_a: str = ""
    pod_b: str = ""
    rtt_results: list[RTTResult] = field(default_factory=list)
    average_rtt_ms: float = 0.0
    success_rate: float = 0.0
    test_count: int = 0
    latency_assessment: str = ""  # excellent | good | fair | poor | very_poor


# ---------------------------------------------------------------------------
# UAV report (ref pkg/models/models.go:181-192); state payload in uav.py
# ---------------------------------------------------------------------------


@dataclass
class UAVReport:
    node_name: str = ""
    node_ip: str = field(default="", metadata=omitempty())
    uav_id: str = ""
    source: str = ""
    status: str = ""
    timestamp: datetime = field(default_factory=utcnow)
    heartbeat_interval_seconds: int = field(default=0, metadata=omitempty())
    state: Any = field(default=None, metadata=omitempty())  # UAVState | dict
    metadata: dict[str, str] = field(default_factory=dict, metadata=omitempty())


# ---------------------------------------------------------------------------
# scheduler models (ref pkg/models/scheduler.go:6-38)
# ---------------------------------------------------------------------------


@dataclass
class SchedulingWorkload:
    name: str = ""
    namespace: str = ""
    type: str = field(default="", metadata=omitempty())


@dataclass
class SchedulingRequestSpec:
    workload: SchedulingWorkload = field(default_factory=SchedulingWorkload)
    minBatteryPercent: float = field(default=0.0, metadata=omitempty())
    preferredNodes: list[str] = field(default_factory=list, metadata=omitempty())
    annotations: dict[str, str] = field(default_factory=dict, metadata=omitempty())


@dataclass
class SchedulingRequestStatus:
    phase: str = field(default="", metadata=omitempty())
    assignedNode: str = field(default="", metadata=omitempty())
    assignedUAV: str = field(default="", metadata=omitempty())
    score: float = field(default=0.0, metadata=omitempty())
    message: str = field(default="", metadata=omitempty())
    lastUpdated: datetime | None = field(default=None, metadata=omitempty())


@dataclass
class SchedulingCandidate:
    node_name: str = ""
    uav_id: str = ""
    battery: float = 0.0
    last_heartbeat: datetime | None = None
    score: float = 0.0
