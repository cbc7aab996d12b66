"""Metric sources: node / pod / network / UAV.

Parity target: ``reference/internal/metrics/sources/`` —
``node_metrics.go`` (capacity+usage join, metrics-server degradation
:47-52, disk = capacity−allocatable :117-124, health from conditions
:143-164), ``pod_metrics.go`` (requests/limits aggregation :105-119,
usage rates vs limit :162-171), ``network_metrics.go`` (cross-node pair
preference :133-206, bounded concurrent probes :83-109, HTTP-over-ping
preference :209-270), ``uav_metrics.go`` (agent pod discovery + state
pull :62-172).

TPU-first extension: nodes exposing ``google.com/tpu`` capacity surface
their chips through the accelerator fields (the reference zeroes GPU
fields with a "to be filled from CRDs" placeholder, node_metrics.go:188-197
— here the fields are actually populated).
"""

from __future__ import annotations

import json
import logging
import threading
import urllib.request
from typing import Any, Callable

from k8s_llm_monitor_tpu_torch.devtools.lockcheck import make_lock
from k8s_llm_monitor_tpu_torch.monitor.client import Client
from k8s_llm_monitor_tpu_torch.monitor.cluster import (
    ClusterError,
    parse_cpu_millis,
    parse_mem_bytes,
)
from k8s_llm_monitor_tpu_torch.monitor.metrics_types import (
    ContainerMetrics,
    NetworkMetrics,
    NodeMetrics,
    PodMetrics,
)
from k8s_llm_monitor_tpu_torch.monitor.models import parse_rfc3339, utcnow
from k8s_llm_monitor_tpu_torch.monitor.rtt import RTTTester

logger = logging.getLogger("monitor.sources")

PRESSURE_CONDITIONS = ("MemoryPressure", "DiskPressure", "PIDPressure", "NetworkUnavailable")
UAV_AGENT_LABEL = ("app", "uav-agent")
UAV_AGENT_PORT = 9090


class NodeMetricsSource:
    """Capacity from the node objects + usage from metrics.k8s.io."""

    def __init__(self, client: Client) -> None:
        self.client = client

    def collect(self) -> dict[str, NodeMetrics]:
        nodes = self.client.backend.list_nodes()
        usage_by_node: dict[str, dict] = {}
        try:
            for item in self.client.backend.node_usage():
                usage_by_node[item["metadata"]["name"]] = item.get("usage", {})
        except ClusterError as exc:
            # degrade to capacity-only (ref node_metrics.go:47-52)
            logger.warning("metrics-server unavailable, capacity-only: %s", exc)

        out: dict[str, NodeMetrics] = {}
        for node in nodes:
            out[node["metadata"]["name"]] = self._build(node, usage_by_node)
        return out

    def _build(self, node: dict, usage_by_node: dict[str, dict]) -> NodeMetrics:
        name = node["metadata"]["name"]
        status = node.get("status", {})
        capacity = status.get("capacity", {})
        allocatable = status.get("allocatable", {})
        usage = usage_by_node.get(name, {})

        m = NodeMetrics(node_name=name, timestamp=utcnow())
        m.cpu_capacity = parse_cpu_millis(capacity.get("cpu"))
        m.cpu_usage = parse_cpu_millis(usage.get("cpu"))
        if m.cpu_capacity > 0:
            m.cpu_usage_rate = m.cpu_usage / m.cpu_capacity * 100.0

        m.memory_capacity = parse_mem_bytes(capacity.get("memory"))
        m.memory_usage = parse_mem_bytes(usage.get("memory"))
        if m.memory_capacity > 0:
            m.memory_usage_rate = m.memory_usage / m.memory_capacity * 100.0

        # disk: estimate used as capacity − allocatable (ref :117-124)
        m.disk_capacity = parse_mem_bytes(capacity.get("ephemeral-storage"))
        alloc_disk = parse_mem_bytes(allocatable.get("ephemeral-storage"))
        if m.disk_capacity > 0 and alloc_disk > 0:
            m.disk_usage = max(0, m.disk_capacity - alloc_disk)
            m.disk_usage_rate = m.disk_usage / m.disk_capacity * 100.0

        # health: Ready + absence of pressure conditions (ref :143-164)
        conditions = status.get("conditions", [])
        ready = any(
            c.get("type") == "Ready" and c.get("status") == "True" for c in conditions
        )
        bad = [
            c["type"]
            for c in conditions
            if c.get("type") in PRESSURE_CONDITIONS and c.get("status") == "True"
        ]
        m.healthy = ready and not bad
        m.conditions = bad if ready else bad + ["NotReady"]
        m.labels = dict(node["metadata"].get("labels", {}) or {})

        # TPU accelerators through the accelerator fields
        tpu_count = int(capacity.get("google.com/tpu", 0) or 0)
        if tpu_count:
            model = m.labels.get("cloud.google.com/gke-tpu-accelerator", "tpu")
            m.gpu_count = tpu_count
            m.gpu_models = [model] * tpu_count
            m.gpu_usage = [0.0] * tpu_count
            m.custom_metrics["accelerator_type"] = "tpu"
        return m


class PodMetricsSource:
    """Per-namespace join of pod specs with metrics.k8s.io pod usage."""

    def __init__(self, client: Client, namespaces: list[str]) -> None:
        self.client = client
        self.namespaces = list(namespaces)

    def collect(self) -> dict[str, PodMetrics]:
        out: dict[str, PodMetrics] = {}
        for ns in self.namespaces:
            usage_by_pod: dict[str, dict] = {}
            try:
                for item in self.client.backend.pod_usage(ns):
                    usage_by_pod[item["metadata"]["name"]] = item
            except ClusterError as exc:
                logger.warning("pod usage unavailable in %s: %s", ns, exc)
            try:
                pods = self.client.backend.list_pods(ns)
            except ClusterError as exc:
                logger.warning("pod listing failed in %s: %s", ns, exc)
                continue
            for pod in pods:
                pm = self._build(pod, usage_by_pod)
                out[f"{pm.namespace}/{pm.pod_name}"] = pm
        return out

    def _build(self, pod: dict, usage_by_pod: dict[str, dict]) -> PodMetrics:
        md = pod.get("metadata", {})
        spec = pod.get("spec", {})
        status = pod.get("status", {})
        name = md.get("name", "")

        pm = PodMetrics(
            pod_name=name,
            namespace=md.get("namespace", ""),
            node_name=spec.get("nodeName", ""),
            timestamp=utcnow(),
            phase=status.get("phase", ""),
            start_time=parse_rfc3339(status.get("startTime")) or utcnow(),
        )

        usage_containers = {
            c.get("name"): c.get("usage", {})
            for c in usage_by_pod.get(name, {}).get("containers", [])
        }
        statuses = {s.get("name"): s for s in status.get("containerStatuses", [])}

        for c in spec.get("containers", []):
            cname = c.get("name", "")
            res = c.get("resources", {})
            requests = res.get("requests", {})
            limits = res.get("limits", {})
            cu = usage_containers.get(cname, {})
            cm = ContainerMetrics(
                name=cname,
                cpu_usage=parse_cpu_millis(cu.get("cpu")),
                memory_usage=parse_mem_bytes(cu.get("memory")),
                cpu_request=parse_cpu_millis(requests.get("cpu")),
                cpu_limit=parse_cpu_millis(limits.get("cpu")),
                memory_request=parse_mem_bytes(requests.get("memory")),
                memory_limit=parse_mem_bytes(limits.get("memory")),
            )
            pm.containers.append(cm)
            pm.cpu_usage += cm.cpu_usage
            pm.memory_usage += cm.memory_usage
            pm.cpu_request += cm.cpu_request
            pm.cpu_limit += cm.cpu_limit
            pm.memory_request += cm.memory_request
            pm.memory_limit += cm.memory_limit

        # usage rate relative to LIMIT (ref pod_metrics.go:162-171)
        if pm.cpu_limit > 0:
            pm.cpu_usage_rate = pm.cpu_usage / pm.cpu_limit * 100.0
        if pm.memory_limit > 0:
            pm.memory_usage_rate = pm.memory_usage / pm.memory_limit * 100.0

        pm.restarts = sum(int(s.get("restartCount", 0)) for s in statuses.values())
        pm.ready = bool(statuses) and all(s.get("ready") for s in statuses.values())
        return pm


class NetworkMetricsSource:
    """Probes RTT between automatically selected Running-pod pairs."""

    def __init__(
        self,
        client: Client,
        namespaces: list[str],
        max_pairs: int = 5,
        concurrency: int = 3,
        timeout: float = 10.0,
    ) -> None:
        self.client = client
        self.namespaces = list(namespaces)
        self.max_pairs = max_pairs
        self.concurrency = concurrency
        self.timeout = timeout
        self.tester = RTTTester(client)

    # -- pair selection (ref network_metrics.go:133-206) -----------------------

    def select_pod_pairs(self) -> list[tuple[str, str]]:
        """Up to ``max_pairs`` Running-pod pairs, cross-node pairs first."""
        pods = []
        for ns in self.namespaces:
            try:
                for p in self.client.get_pods(ns):
                    if p.status == "Running" and p.ip:
                        pods.append(p)
            except ClusterError as exc:
                logger.warning("pair selection: list pods %s failed: %s", ns, exc)
        refs = [f"{p.namespace}/{p.name}" for p in pods]
        # Bounded enumeration (the full product is O(n^2) in pod count, ref
        # network_metrics.go:166-167 caps both loops): stop once we have
        # max_pairs cross-node pairs; same-node pairs only fill a shortfall.
        cross, same = [], []
        for i in range(len(pods)):
            if len(cross) >= self.max_pairs:
                break
            for j in range(i + 1, len(pods)):
                if len(cross) >= self.max_pairs:
                    break
                pair = (refs[i], refs[j])
                if pods[i].node_name and pods[i].node_name != pods[j].node_name:
                    cross.append(pair)
                elif len(same) < self.max_pairs:
                    same.append(pair)
        return (cross + same)[: self.max_pairs]

    # -- collection (ref network_metrics.go:66-109) ----------------------------

    def collect(self) -> list[NetworkMetrics]:
        pairs = self.select_pod_pairs()
        if not pairs:
            return []
        results: list[NetworkMetrics | None] = [None] * len(pairs)
        sem = threading.Semaphore(self.concurrency)

        def probe(idx: int, pair: tuple[str, str]) -> None:
            with sem:
                results[idx] = self.test_pair(pair[0], pair[1])

        threads = [
            threading.Thread(target=probe, args=(i, p), daemon=True)
            for i, p in enumerate(pairs)
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=self.timeout + 5)
        return [r for r in results if r is not None]

    # -- per-pair probe (ref network_metrics.go:209-270) -----------------------

    def test_pair(self, pod_a: str, pod_b: str) -> NetworkMetrics:
        nm = NetworkMetrics(source_pod=pod_a, target_pod=pod_b, timestamp=utcnow())
        try:
            result = self.tester.test_pod_connectivity(pod_a, pod_b)
        except ClusterError as exc:
            nm.error = str(exc)
            nm.test_method = "ping"
            return nm
        ping = [r for r in result.rtt_results if r.method.startswith("ping") and r.success]
        http = [r for r in result.rtt_results if r.method == "http" and r.success]
        if http:  # HTTP RTT preferred when both succeed
            nm.connected = True
            nm.rtt_ms = http[0].rtt_ms
            nm.test_method = "http"
        elif ping:
            nm.connected = True
            nm.rtt_ms = sum(r.rtt_ms for r in ping) / len(ping)
            nm.test_method = "ping"
        else:
            nm.test_method = "ping"
            errors = [r.error_message for r in result.rtt_results if r.error_message]
            nm.error = errors[0] if errors else "all probes failed"
        if result.rtt_results:
            nm.packet_loss = max(r.packet_loss for r in result.rtt_results)
        return nm


# fetcher seam so tests/dev mode can serve UAV state without real pod HTTP
StateFetcher = Callable[[str], dict[str, Any]]


def http_state_fetcher(url: str) -> dict[str, Any]:
    with urllib.request.urlopen(url, timeout=5) as resp:
        return json.loads(resp.read())


def http_command_poster(url: str, payload: dict[str, Any]) -> dict[str, Any]:
    req = urllib.request.Request(
        url,
        data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"},
        method="POST",
    )
    with urllib.request.urlopen(req, timeout=5) as resp:
        return json.loads(resp.read())


class UAVMetricsSource:
    """Pulls UAV state from per-node agent pods (``app=uav-agent``)."""

    def __init__(
        self,
        client: Client,
        namespace: str = "default",
        fetcher: StateFetcher | None = None,
        port: int = UAV_AGENT_PORT,
        poster=None,
    ) -> None:
        self.client = client
        self.namespace = namespace
        self.fetcher = fetcher or http_state_fetcher
        self.poster = poster or http_command_poster
        self.port = port

    def agent_pods(self):
        key, value = UAV_AGENT_LABEL
        return [
            p
            for p in self.client.get_pods(self.namespace)
            if p.status == "Running" and p.labels.get(key) == value and p.ip
        ]

    def collect(self) -> dict[str, dict[str, Any]]:
        """node name → raw UAV state dict (ref uav_metrics.go:62-172)."""
        out: dict[str, dict[str, Any]] = {}
        lock = make_lock("uav_source.merge")

        def pull(pod) -> None:
            url = f"http://{pod.ip}:{self.port}/api/v1/state"
            try:
                state = self.fetcher(url)
            except Exception as exc:
                logger.warning("UAV pull from %s (%s) failed: %s", pod.name, url, exc)
                return
            node = pod.node_name or state.get("node_name", pod.name)
            with lock:
                out[node] = state

        threads = [
            threading.Thread(target=pull, args=(p,), daemon=True)
            for p in self.agent_pods()
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=10)
        return out

    def send_command(
        self, node: str, command: str, params: dict[str, Any] | None = None
    ) -> dict[str, Any]:
        """Push a flight command to the agent on ``node`` (ref
        uav_metrics.go:236-287 SendCommandToUAV — whose payload marshaling
        was an unfinished TODO, :254-266; here the body is actually sent).

        Commands map to the agent API: arm/disarm/takeoff/land/rtl/mode
        (monitor/agent.py)."""
        pod = next(
            (p for p in self.agent_pods() if p.node_name == node), None)
        if pod is None:
            raise ValueError(f"no running uav-agent pod on node {node!r}")
        url = f"http://{pod.ip}:{self.port}/api/v1/command/{command}"
        return self.poster(url, params or {})
