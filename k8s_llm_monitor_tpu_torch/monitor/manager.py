"""Metrics manager — concurrent collection + double-buffered snapshot.

Parity target: ``reference/internal/metrics/manager.go`` — source
wiring per config (:61-134), start/ticker loop (:137-179), fan-out collect
with per-source threads and snapshot swap under a lock (:195-334), error
policy (node/pod errors propagate, network errors log-only, :322-331),
pull-side UAV wrapping with ``source:"pull"`` (:265-278), push ingestion
``update_uav_report`` (:391-449), read API (:337-388, :452-490), and the
cluster rollup with the reference's exact thresholds (:493-565).
"""

from __future__ import annotations

import logging
import threading
import time
from datetime import datetime
from typing import Any

from k8s_llm_monitor_tpu_torch.devtools.lockcheck import guarded_by, make_lock
from k8s_llm_monitor_tpu_torch.monitor.client import Client
from k8s_llm_monitor_tpu_torch.monitor.config import MetricsConfig
from k8s_llm_monitor_tpu_torch.monitor.metrics_types import (
    ClusterMetrics,
    MetricsSnapshot,
    NetworkMetrics,
    NodeMetrics,
    PodMetrics,
)
from k8s_llm_monitor_tpu_torch.monitor.models import utcnow
from k8s_llm_monitor_tpu_torch.monitor.sources import (
    NetworkMetricsSource,
    NodeMetricsSource,
    PodMetricsSource,
    StateFetcher,
    UAVMetricsSource,
)

logger = logging.getLogger("monitor.manager")


def _aware(ts: datetime) -> datetime:
    """Treat naive timestamps (agent clocks without an offset) as UTC."""
    from datetime import timezone

    return ts if ts.tzinfo is not None else ts.replace(tzinfo=timezone.utc)


class CollectError(Exception):
    pass


@guarded_by("_lock", "_snapshot", "_uav_snapshot",
            "collect_count", "last_collect_duration")
class Manager:
    """Owns the sources and the latest ``MetricsSnapshot``."""

    def __init__(
        self,
        client: Client,
        cfg: MetricsConfig | None = None,
        uav_fetcher: StateFetcher | None = None,
    ) -> None:
        cfg = cfg or MetricsConfig()
        self.cfg = cfg
        self.client = client
        namespaces = list(cfg.namespaces)

        self.node_source = NodeMetricsSource(client) if cfg.enable_node else None
        self.pod_source = (
            PodMetricsSource(client, namespaces) if cfg.enable_pod else None
        )
        self.network_source = (
            NetworkMetricsSource(
                client,
                namespaces,
                max_pairs=cfg.max_pod_pairs,
                timeout=cfg.network_timeout,
            )
            if cfg.enable_network
            else None
        )
        # UAV collector targets the first configured namespace with the
        # hardcoded agent label, like ref manager.go:121-129
        self.uav_source = (
            UAVMetricsSource(
                client,
                namespace=namespaces[0] if namespaces else "default",
                fetcher=uav_fetcher,
            )
            if cfg.enable_uav
            else None
        )

        self._snapshot = MetricsSnapshot(cluster_metrics=ClusterMetrics())
        self._uav_snapshot: dict[str, dict[str, Any]] = {}
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self.collect_count = 0
        self.last_collect_duration = 0.0
        # Created last: lockcheck's guarded_by treats writes before the
        # lock exists as construction, not races.
        self._lock = make_lock("manager.snapshot", reentrant=True)

    # -- lifecycle (ref manager.go:137-192) ------------------------------------

    def start(self) -> None:
        if self._thread is not None:
            if self._thread.is_alive():
                return
            self._thread = None  # previous loop finished after a timed-out stop
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, name="metrics-manager", daemon=True
        )
        self._thread.start()

    def stop(self, timeout: float = 5.0) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=timeout)
            if self._thread.is_alive():
                # a probe is blocking collect(); keep the handle so a later
                # start() can't spawn a second concurrent loop
                logger.warning("metrics loop still busy after %.1fs stop", timeout)
                return
            self._thread = None

    def _loop(self) -> None:
        # immediate collect, then ticker (ref manager.go:141-179)
        try:
            self.collect()
        except Exception as exc:  # noqa: BLE001 — the loop must survive anything
            logger.exception("initial metrics collection failed: %s", exc)
        while not self._stop.wait(self.cfg.collect_interval):
            try:
                self.collect()
            except Exception as exc:  # noqa: BLE001
                logger.exception("metrics collection failed: %s", exc)

    # -- collection (ref manager.go:195-334) -------------------------------------

    def collect(self) -> MetricsSnapshot:
        start = time.monotonic()
        now = utcnow()
        snapshot = MetricsSnapshot(
            timestamp=now, cluster_metrics=ClusterMetrics(timestamp=now)
        )
        errors: dict[str, Exception] = {}
        uav_raw: dict[str, dict[str, Any]] | None = None

        def run_node() -> None:
            try:
                snapshot.node_metrics = self.node_source.collect()
            except Exception as exc:  # noqa: BLE001 — error policy is per-source
                errors["node"] = exc

        def run_pod() -> None:
            try:
                snapshot.pod_metrics = self.pod_source.collect()
            except Exception as exc:  # noqa: BLE001
                errors["pod"] = exc

        def run_network() -> None:
            try:
                snapshot.network_metrics = self.network_source.collect()
            except Exception as exc:  # noqa: BLE001
                errors["network"] = exc

        def run_uav() -> None:
            nonlocal uav_raw
            try:
                uav_raw = self.uav_source.collect()
            except Exception as exc:  # noqa: BLE001
                errors["uav"] = exc

        jobs = []
        if self.node_source:
            jobs.append(threading.Thread(target=run_node, daemon=True))
        if self.pod_source:
            jobs.append(threading.Thread(target=run_pod, daemon=True))
        if self.network_source:
            jobs.append(threading.Thread(target=run_network, daemon=True))
        if self.uav_source:
            jobs.append(threading.Thread(target=run_uav, daemon=True))
        for t in jobs:
            t.start()
        for t in jobs:
            t.join()

        self._calculate_cluster_metrics(snapshot)

        # pull-side UAV entries wrapped with source:"pull" (ref :265-278)
        uav_entries: dict[str, dict[str, Any]] | None = None
        if uav_raw is not None:
            uav_entries = {
                node: {
                    "node_name": node,
                    "status": "active",
                    "source": "pull",
                    "timestamp": now,
                    "last_heartbeat": now,
                    "state": state,
                }
                for node, state in uav_raw.items()
            }

        with self._lock:
            self._snapshot = snapshot
            if uav_entries is not None:
                # Rebuild from this cycle's pull results (the reference
                # replaces the snapshot wholesale, which self-prunes removed
                # nodes), then retain push-side ("agent") entries whose
                # heartbeat is still fresh — pushes carry richer state. An
                # entry advertising its own heartbeat interval widens the
                # window so slow pushers don't flap between shapes.
                merged = dict(uav_entries)
                for node, existing in self._uav_snapshot.items():
                    hb = existing.get("last_heartbeat")
                    interval = existing.get("heartbeat_interval_seconds", 0) or 0
                    fresh_window = max(
                        interval * 2, self.cfg.collect_interval * 2, 30
                    )
                    if (
                        existing.get("source") == "agent"
                        and isinstance(hb, datetime)
                        and (now - _aware(hb)).total_seconds() < fresh_window
                    ):
                        merged[node] = existing
                self._uav_snapshot = merged
            # Counters live under the same lock as the snapshot: status
            # readers report (snapshot, collect_count, duration) as one
            # consistent triple.  Writing them outside the lock raced the
            # readers — lockcheck's guarded_by caught this.
            self.last_collect_duration = time.monotonic() - start
            self.collect_count += 1
        logger.info(
            "metrics collection completed in %.2fs (nodes: %d, pods: %d, network: %d, uavs: %d)",
            self.last_collect_duration,
            len(snapshot.node_metrics),
            len(snapshot.pod_metrics),
            len(snapshot.network_metrics),
            len(uav_raw or {}),
        )

        # error policy (ref manager.go:322-331)
        if "node" in errors:
            raise CollectError(f"node metrics: {errors['node']}")
        if "pod" in errors:
            raise CollectError(f"pod metrics: {errors['pod']}")
        if "network" in errors:
            logger.warning("network metrics collection had errors: %s", errors["network"])
        if "uav" in errors:
            logger.warning("uav metrics collection had errors: %s", errors["uav"])
        return snapshot

    # -- push ingestion (ref manager.go:391-449) ---------------------------------

    def update_uav_report(self, report) -> None:
        if report is None or not report.node_name:
            return
        ts = _aware(report.timestamp) if report.timestamp else utcnow()
        entry: dict[str, Any] = {
            "node_name": report.node_name,
            "uav_id": report.uav_id,
            "status": report.status or "active",
            "source": report.source or "agent",
            "timestamp": ts,
            "last_heartbeat": ts,
        }
        if report.node_ip:
            entry["node_ip"] = report.node_ip
        if report.heartbeat_interval_seconds > 0:
            entry["heartbeat_interval_seconds"] = report.heartbeat_interval_seconds
        if report.metadata:
            entry["metadata"] = dict(report.metadata)
        if report.state is not None:
            entry["state"] = report.state
        with self._lock:
            self._uav_snapshot[report.node_name] = entry
        logger.debug(
            "UAV report ingested: node=%s uav=%s status=%s",
            report.node_name,
            report.uav_id,
            entry["status"],
        )

    # -- read API (ref manager.go:337-388, 452-490) -------------------------------

    def get_latest_snapshot(self) -> MetricsSnapshot:
        with self._lock:
            return self._snapshot

    def get_node_metrics(self, node_name: str) -> NodeMetrics:
        with self._lock:
            node = self._snapshot.node_metrics.get(node_name)
        if node is None:
            raise KeyError(f"node {node_name} not found in snapshot")
        return node

    def get_pod_metrics(self, namespace: str, name: str) -> PodMetrics:
        with self._lock:
            pod = self._snapshot.pod_metrics.get(f"{namespace}/{name}")
        if pod is None:
            raise KeyError(f"pod {namespace}/{name} not found in snapshot")
        return pod

    def get_cluster_metrics(self) -> ClusterMetrics:
        with self._lock:
            return self._snapshot.cluster_metrics or ClusterMetrics()

    def get_network_metrics(self) -> list[NetworkMetrics]:
        with self._lock:
            return list(self._snapshot.network_metrics)

    def get_uav_metrics(self) -> dict[str, dict[str, Any]]:
        with self._lock:
            return dict(self._uav_snapshot)

    def get_single_uav_metrics(self, node_name: str) -> dict[str, Any] | None:
        with self._lock:
            entry = self._uav_snapshot.get(node_name)
            return dict(entry) if entry is not None else None

    def send_uav_command(
        self, node: str, command: str, params: dict[str, Any] | None = None
    ) -> dict[str, Any]:
        """Push a flight command to a node's UAV agent (ref SendCommandToUAV,
        uav_metrics.go:236-287).  Requires the UAV source to be enabled."""
        if self.uav_source is None:
            raise ValueError("UAV metrics source is disabled")
        return self.uav_source.send_command(node, command, params)

    def uav_heartbeats(self) -> dict[str, datetime]:
        """Derived from the snapshot entries — single source of truth."""
        with self._lock:
            return {
                node: _aware(e["last_heartbeat"])
                for node, e in self._uav_snapshot.items()
                if isinstance(e.get("last_heartbeat"), datetime)
            }

    def test_pod_communication(self, pod_a: str, pod_b: str) -> NetworkMetrics:
        """On-demand single-pair probe (ref network_metrics.go:292-325)."""
        source = self.network_source or NetworkMetricsSource(
            self.client, self.cfg.namespaces
        )
        return source.test_pair(pod_a, pod_b)

    # -- cluster rollup (ref manager.go:493-565) ----------------------------------

    def _calculate_cluster_metrics(self, snapshot: MetricsSnapshot) -> None:
        cluster = snapshot.cluster_metrics
        nodes = snapshot.node_metrics.values()
        pods = snapshot.pod_metrics.values()

        cluster.total_nodes = len(snapshot.node_metrics)
        cluster.healthy_nodes = sum(1 for n in nodes if n.healthy)
        cluster.total_pods = len(snapshot.pod_metrics)
        cluster.running_pods = sum(1 for p in pods if p.phase == "Running")

        cluster.total_cpu = sum(n.cpu_capacity for n in nodes)
        cluster.used_cpu = sum(n.cpu_usage for n in nodes)
        cluster.total_memory = sum(n.memory_capacity for n in nodes)
        cluster.used_memory = sum(n.memory_usage for n in nodes)
        cluster.total_gpus = sum(n.gpu_count for n in nodes)
        # "available" accelerator = usage < 50% (ref manager.go:529-535)
        cluster.available_gpus = sum(
            1 for n in nodes for u in n.gpu_usage if u < 50.0
        )

        if cluster.total_cpu > 0:
            cluster.cpu_usage_rate = cluster.used_cpu / cluster.total_cpu * 100.0
        if cluster.total_memory > 0:
            cluster.memory_usage_rate = (
                cluster.used_memory / cluster.total_memory * 100.0
            )

        cluster.issues = []
        if cluster.healthy_nodes < cluster.total_nodes:
            cluster.issues.append(
                f"{cluster.total_nodes - cluster.healthy_nodes} nodes are unhealthy"
            )
        if cluster.cpu_usage_rate > 80:
            cluster.issues.append(f"High CPU usage: {cluster.cpu_usage_rate:.1f}%")
        if cluster.memory_usage_rate > 80:
            cluster.issues.append(
                f"High memory usage: {cluster.memory_usage_rate:.1f}%"
            )

        if not cluster.issues:
            cluster.health_status = "healthy"
        elif (
            cluster.cpu_usage_rate > 90
            or cluster.memory_usage_rate > 90
            or cluster.healthy_nodes < cluster.total_nodes / 2
        ):
            cluster.health_status = "critical"
        else:
            cluster.health_status = "warning"
