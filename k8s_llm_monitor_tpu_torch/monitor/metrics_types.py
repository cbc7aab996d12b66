"""Metrics data models + behavior helpers.

Parity target: ``reference/pkg/metrics/types.go`` (NodeMetrics …
MetricsSnapshot, types.go:8-148; helper methods types.go:151-199). Field
names are the wire names; thresholds match the reference exactly
(pressure 80/80/90, over-limit 90%, quality bands <10/<50/<100 ms).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from datetime import datetime
from typing import Any

from k8s_llm_monitor_tpu_torch.monitor.models import omitempty, utcnow


@dataclass
class NodeMetrics:
    node_name: str = ""
    timestamp: datetime = field(default_factory=utcnow)

    # CPU (millicores)
    cpu_capacity: int = 0
    cpu_usage: int = 0
    cpu_usage_rate: float = 0.0

    # memory (bytes)
    memory_capacity: int = 0
    memory_usage: int = 0
    memory_usage_rate: float = 0.0

    # disk (bytes)
    disk_capacity: int = 0
    disk_usage: int = 0
    disk_usage_rate: float = 0.0

    # network (from CRDs or probes)
    network_latency: float = 0.0  # ms
    network_bandwidth: float = 0.0  # Mbps

    # accelerators (from CRD extensions; the TPU build also reports TPU
    # chips through these fields — see sources.py)
    gpu_count: int = 0
    gpu_models: list[str] = field(default_factory=list)
    gpu_usage: list[float] = field(default_factory=list)
    gpu_memory_total: list[int] = field(default_factory=list)  # MB
    gpu_memory_used: list[int] = field(default_factory=list)  # MB

    healthy: bool = True
    conditions: list[str] = field(default_factory=list)
    labels: dict[str, str] = field(default_factory=dict)
    custom_metrics: dict[str, Any] = field(default_factory=dict, metadata=omitempty())

    # --- behavior (ref types.go:151-162) ---

    def available_resources(self) -> tuple[float, float, float]:
        """(cpu cores, memory GB, disk GB) still available."""
        cpu = (self.cpu_capacity - self.cpu_usage) / 1000.0
        mem = (self.memory_capacity - self.memory_usage) / 1024**3
        disk = (self.disk_capacity - self.disk_usage) / 1024**3
        return cpu, mem, disk

    def is_under_pressure(self) -> bool:
        return (
            self.cpu_usage_rate > 80.0
            or self.memory_usage_rate > 80.0
            or self.disk_usage_rate > 90.0
        )


@dataclass
class ContainerMetrics:
    name: str = ""
    cpu_usage: int = 0
    memory_usage: int = 0
    cpu_request: int = 0
    cpu_limit: int = 0
    memory_request: int = 0
    memory_limit: int = 0


@dataclass
class PodMetrics:
    pod_name: str = ""
    namespace: str = ""
    node_name: str = ""
    timestamp: datetime = field(default_factory=utcnow)

    cpu_usage: int = 0  # millicores
    memory_usage: int = 0  # bytes

    cpu_request: int = 0
    cpu_limit: int = 0
    memory_request: int = 0
    memory_limit: int = 0

    cpu_usage_rate: float = 0.0  # vs limit
    memory_usage_rate: float = 0.0  # vs limit

    containers: list[ContainerMetrics] = field(default_factory=list)

    phase: str = ""
    ready: bool = False
    restarts: int = 0
    start_time: datetime = field(default_factory=utcnow)

    # --- behavior (ref types.go:165-184) ---

    def resource_utilization(self) -> tuple[float, float]:
        """(cpu %, mem %) relative to requests."""
        cpu = (
            self.cpu_usage / self.cpu_request * 100.0 if self.cpu_request > 0 else 0.0
        )
        mem = (
            self.memory_usage / self.memory_request * 100.0
            if self.memory_request > 0
            else 0.0
        )
        return cpu, mem

    def is_over_limit(self) -> bool:
        if self.cpu_limit > 0 and self.cpu_usage >= self.cpu_limit * 0.9:
            return True
        if self.memory_limit > 0 and self.memory_usage >= self.memory_limit * 0.9:
            return True
        return False


@dataclass
class NetworkMetrics:
    source_pod: str = ""
    target_pod: str = ""
    timestamp: datetime = field(default_factory=utcnow)

    connected: bool = False
    error: str = field(default="", metadata=omitempty())

    rtt_ms: float = 0.0
    packet_loss: float = 0.0  # 0-100

    bandwidth_mbps: float = field(default=0.0, metadata=omitempty())
    test_method: str = ""  # ping | http | tcp

    def quality(self) -> str:
        """Quality bands per ref types.go:187-199."""
        if not self.connected:
            return "disconnected"
        if self.rtt_ms < 10:
            return "excellent"
        if self.rtt_ms < 50:
            return "good"
        if self.rtt_ms < 100:
            return "fair"
        return "poor"


@dataclass
class ClusterMetrics:
    timestamp: datetime = field(default_factory=utcnow)

    total_nodes: int = 0
    healthy_nodes: int = 0
    total_pods: int = 0
    running_pods: int = 0

    total_cpu: int = 0  # millicores
    used_cpu: int = 0
    cpu_usage_rate: float = 0.0

    total_memory: int = 0  # bytes
    used_memory: int = 0
    memory_usage_rate: float = 0.0

    total_gpus: int = 0
    available_gpus: int = 0

    health_status: str = "healthy"  # healthy | warning | critical
    issues: list[str] = field(default_factory=list, metadata=omitempty())


@dataclass
class MetricsSnapshot:
    timestamp: datetime = field(default_factory=utcnow)
    node_metrics: dict[str, NodeMetrics] = field(default_factory=dict)
    pod_metrics: dict[str, PodMetrics] = field(default_factory=dict)  # ns/name
    network_metrics: list[NetworkMetrics] = field(default_factory=list)
    cluster_metrics: ClusterMetrics | None = None
