"""Cluster backend seam + fake in-memory cluster.

The reference talks to a real Kubernetes API server through client-go
(``reference/internal/k8s/client.go:25-45``) and is consequently
untestable without a cluster (zero test files, SURVEY §4). This module
fixes that: every cluster touchpoint the product needs — lists, logs, exec,
watch streams, CRDs/CRs, metrics-server usage — goes through the
``ClusterBackend`` interface, with two implementations:

- ``FakeCluster`` (here): an in-memory cluster with real watch-stream
  semantics (subscriber queues, closable streams for reconnect tests),
  failure injection, and an exec simulator for the RTT probes.
- ``KubeRestBackend`` (kube_rest.py): a stdlib-HTTP client speaking to a
  real API server via kubeconfig (no external k8s package needed).

Objects cross the seam in Kubernetes API wire shape (metadata/spec/status
dicts), so converters and consumers behave identically against both
backends.
"""

from __future__ import annotations

import copy
import itertools
import queue
import re
import threading
from datetime import datetime, timezone
from typing import Any, Callable, Iterator

from k8s_llm_monitor_tpu_torch.devtools.lockcheck import make_lock
from k8s_llm_monitor_tpu_torch.monitor.models import rfc3339, utcnow

# ---------------------------------------------------------------------------
# resource-quantity parsing (cpu millicores, memory bytes)
# ---------------------------------------------------------------------------

_MEM_SUFFIX = {
    "Ki": 1024,
    "Mi": 1024**2,
    "Gi": 1024**3,
    "Ti": 1024**4,
    "Pi": 1024**5,
    "K": 1000,
    "k": 1000,
    "M": 1000**2,
    "G": 1000**3,
    "T": 1000**4,
    "P": 1000**5,
}


def parse_cpu_millis(q: str | int | float | None) -> int:
    """'250m' → 250, '2' → 2000, '1.5' → 1500, 100n → 0 (sub-milli floors)."""
    if q is None or q == "":
        return 0
    if isinstance(q, (int, float)):
        return int(float(q) * 1000)
    s = str(q).strip()
    if s.endswith("n"):
        return int(float(s[:-1]) / 1e6)
    if s.endswith("u"):
        return int(float(s[:-1]) / 1e3)
    if s.endswith("m"):
        return int(float(s[:-1]))
    return int(float(s) * 1000)


def parse_mem_bytes(q: str | int | float | None) -> int:
    """'128Mi' → 134217728, '1Gi' → 2**30, plain number → bytes."""
    if q is None or q == "":
        return 0
    if isinstance(q, (int, float)):
        return int(q)
    s = str(q).strip()
    for suffix, mult in _MEM_SUFFIX.items():
        if s.endswith(suffix):
            return int(float(s[: -len(suffix)]) * mult)
    return int(float(s))


# ---------------------------------------------------------------------------
# watch streams
# ---------------------------------------------------------------------------


class WatchStream:
    """One live watch: iterate (event_type, object) until closed.

    ``event_type`` ∈ {"ADDED", "MODIFIED", "DELETED"}; iteration ends when
    the stream closes (server side or via ``close()``), mirroring a k8s
    watch channel closing so consumers exercise their reconnect loops.
    """

    _CLOSE = object()

    def __init__(self) -> None:
        self._q: queue.Queue[Any] = queue.Queue()
        self._closed = threading.Event()

    def put(self, event_type: str, obj: dict[str, Any]) -> None:
        if not self._closed.is_set():
            self._q.put((event_type, obj))

    def close(self) -> None:
        if not self._closed.is_set():
            self._closed.set()
            self._q.put(self._CLOSE)

    @property
    def closed(self) -> bool:
        return self._closed.is_set()

    def __iter__(self) -> Iterator[tuple[str, dict[str, Any]]]:
        while True:
            if self._closed.is_set() and self._q.empty():
                return  # closed and drained (incl. re-iteration after close)
            item = self._q.get()
            if item is self._CLOSE:
                self._q.put(self._CLOSE)  # keep the sentinel for other readers
                return
            yield item


# ---------------------------------------------------------------------------
# backend interface
# ---------------------------------------------------------------------------


class ClusterError(Exception):
    """Any backend failure (unreachable API, missing resource, ...)."""


class NotFound(ClusterError):
    pass


class Conflict(ClusterError):
    pass


class ClusterBackend:
    """The seam every cluster touchpoint goes through.

    All list/get results are deep copies in Kubernetes wire shape.
    Subclasses must implement everything; the base raises.
    """

    # -- discovery / core reads
    def server_version(self) -> str:
        raise NotImplementedError

    def list_nodes(self) -> list[dict[str, Any]]:
        raise NotImplementedError

    def list_pods(self, namespace: str) -> list[dict[str, Any]]:
        raise NotImplementedError

    def list_services(self, namespace: str) -> list[dict[str, Any]]:
        raise NotImplementedError

    def list_events(self, namespace: str, limit: int = 0) -> list[dict[str, Any]]:
        raise NotImplementedError

    def list_network_policies(self, namespace: str) -> list[dict[str, Any]]:
        raise NotImplementedError

    def pod_logs(self, namespace: str, name: str, tail_lines: int = 100) -> str:
        raise NotImplementedError

    def exec_in_pod(
        self, namespace: str, pod: str, command: list[str], timeout: float = 10.0
    ) -> tuple[str, str, int]:
        """Run a command in a pod; returns (stdout, stderr, exit code)."""
        raise NotImplementedError

    # -- metrics.k8s.io
    def node_usage(self) -> list[dict[str, Any]]:
        """NodeMetrics list items: {metadata.name, usage:{cpu,memory}}."""
        raise NotImplementedError

    def pod_usage(self, namespace: str) -> list[dict[str, Any]]:
        """PodMetrics list items incl. containers[].usage."""
        raise NotImplementedError

    # -- watches
    def watch(self, kind: str, namespace: str) -> WatchStream:
        """kind ∈ {pods, services, events}."""
        raise NotImplementedError

    def watch_crds(self) -> WatchStream:
        raise NotImplementedError

    def watch_custom_resources(
        self, group: str, version: str, plural: str, namespace: str | None
    ) -> WatchStream:
        raise NotImplementedError

    # -- CRDs / custom resources (dynamic client equivalent)
    def list_crds(self) -> list[dict[str, Any]]:
        raise NotImplementedError

    def list_custom_resources(
        self, group: str, version: str, plural: str, namespace: str | None
    ) -> list[dict[str, Any]]:
        raise NotImplementedError

    def get_custom_resource(
        self, group: str, version: str, plural: str, namespace: str | None, name: str
    ) -> dict[str, Any]:
        raise NotImplementedError

    def create_custom_resource(
        self,
        group: str,
        version: str,
        plural: str,
        namespace: str | None,
        body: dict[str, Any],
    ) -> dict[str, Any]:
        raise NotImplementedError

    def update_custom_resource(
        self,
        group: str,
        version: str,
        plural: str,
        namespace: str | None,
        body: dict[str, Any],
    ) -> dict[str, Any]:
        raise NotImplementedError

    def update_custom_resource_status(
        self,
        group: str,
        version: str,
        plural: str,
        namespace: str | None,
        body: dict[str, Any],
    ) -> dict[str, Any]:
        raise NotImplementedError


# ---------------------------------------------------------------------------
# fake in-memory cluster
# ---------------------------------------------------------------------------

ExecHandler = Callable[[str, str, list[str]], tuple[str, str, int]]


class FakeCluster(ClusterBackend):
    """In-memory cluster with watch fan-out, failure injection, exec sim.

    Test ergonomics:
    - builder helpers (``add_node``/``add_pod``/... ) accept plain kwargs
      and fill in wire-shape boilerplate;
    - ``fail_next("list_pods", n)`` makes the next n calls raise, and
      ``close_watches()`` severs live streams — both for recovery tests;
    - exec is simulated: ``ping``/``curl`` get synthetic outputs whose RTT
      depends on whether source and target share a node (override per-pod
      with ``set_exec_handler``).
    """

    def __init__(self, version: str = "v1.29.0-fake") -> None:
        self._lock = make_lock("fake_cluster", reentrant=True)
        self._version = version
        self._nodes: dict[str, dict] = {}
        self._pods: dict[tuple[str, str], dict] = {}  # (ns, name)
        self._services: dict[tuple[str, str], dict] = {}
        self._statefulsets: dict[tuple[str, str], dict] = {}
        self._events: dict[str, list[dict]] = {}  # ns -> list
        self._netpols: dict[tuple[str, str], dict] = {}
        self._logs: dict[tuple[str, str], list[str]] = {}
        self._crds: dict[str, dict] = {}  # metadata.name
        # (group, plural, ns or "", name) -> object
        self._crs: dict[tuple[str, str, str, str], dict] = {}
        self._node_usage: dict[str, dict[str, Any]] = {}
        self._pod_usage: dict[tuple[str, str], dict[str, Any]] = {}
        self._watchers: dict[tuple, list[WatchStream]] = {}
        self._fail: dict[str, int] = {}
        self._exec_handler: ExecHandler | None = None
        self._uid = itertools.count(1)
        self.metrics_server_available = True
        # synthetic RTT model for the exec simulator (ms)
        self.same_node_rtt_ms = 0.4
        self.cross_node_rtt_ms = 2.5

    # -- failure injection ---------------------------------------------------

    def fail_next(self, method: str, times: int = 1) -> None:
        with self._lock:
            self._fail[method] = self._fail.get(method, 0) + times

    def _maybe_fail(self, method: str) -> None:
        with self._lock:
            n = self._fail.get(method, 0)
            if n > 0:
                self._fail[method] = n - 1
                raise ClusterError(f"injected failure: {method}")

    def close_watches(self) -> None:
        """Sever all live watch streams (tests of reconnect loops)."""
        with self._lock:
            streams = [s for lst in self._watchers.values() for s in lst]
            self._watchers.clear()
        for s in streams:
            s.close()

    # -- builders ------------------------------------------------------------

    def add_node(
        self,
        name: str,
        cpu: str = "4",
        memory: str = "16Gi",
        disk: str = "100Gi",
        labels: dict[str, str] | None = None,
        ready: bool = True,
        pressure: list[str] | None = None,
        tpu_chips: int = 0,
        tpu_model: str = "tpu-v5e",
    ) -> dict:
        alloc_factor = 0.95
        capacity = {
            "cpu": cpu,
            "memory": memory,
            "ephemeral-storage": disk,
        }
        allocatable = {
            "cpu": f"{int(parse_cpu_millis(cpu) * alloc_factor)}m",
            "memory": str(int(parse_mem_bytes(memory) * alloc_factor)),
            "ephemeral-storage": str(int(parse_mem_bytes(disk) * alloc_factor)),
        }
        if tpu_chips:
            capacity["google.com/tpu"] = str(tpu_chips)
            allocatable["google.com/tpu"] = str(tpu_chips)
        conditions = [
            {"type": "Ready", "status": "True" if ready else "False"},
        ]
        for cond in pressure or []:
            conditions.append({"type": cond, "status": "True"})
        node = {
            "metadata": {
                "name": name,
                "uid": f"node-{next(self._uid)}",
                "labels": dict(labels or {}),
                "creationTimestamp": rfc3339(utcnow()),
            },
            "status": {
                "capacity": capacity,
                "allocatable": allocatable,
                "conditions": conditions,
                "nodeInfo": {"kubeletVersion": self._version},
            },
        }
        if tpu_chips:
            node["metadata"]["labels"].setdefault(
                "cloud.google.com/gke-tpu-accelerator", tpu_model
            )
        with self._lock:
            self._nodes[name] = node
        return node

    def add_pod(
        self,
        name: str,
        namespace: str = "default",
        node: str = "",
        ip: str = "",
        phase: str = "Running",
        labels: dict[str, str] | None = None,
        containers: list[dict] | None = None,
        image: str = "nginx:1.25",
        ready: bool = True,
        restarts: int = 0,
        requests: dict[str, str] | None = None,
        limits: dict[str, str] | None = None,
        env: dict[str, str] | None = None,
        start_time: datetime | None = None,
    ) -> dict:
        uid = next(self._uid)
        if not ip:
            ip = f"10.244.{uid % 250}.{(uid * 7) % 250 + 1}"
        if containers is None:
            containers = [
                {
                    "name": name.split("-")[0] or "main",
                    "image": image,
                    "env": [{"name": k, "value": v} for k, v in (env or {}).items()],
                    "resources": {
                        "requests": dict(requests or {}),
                        "limits": dict(limits or {}),
                    },
                }
            ]
        statuses = [
            {
                "name": c["name"],
                "ready": ready and phase == "Running",
                "restartCount": restarts,
                "state": (
                    {"running": {"startedAt": rfc3339(start_time or utcnow())}}
                    if phase == "Running"
                    else {"waiting": {"reason": phase}}
                ),
            }
            for c in containers
        ]
        pod = {
            "metadata": {
                "name": name,
                "namespace": namespace,
                "uid": f"pod-{uid}",
                "labels": dict(labels or {}),
                "creationTimestamp": rfc3339(start_time or utcnow()),
            },
            "spec": {"nodeName": node, "containers": containers},
            "status": {
                "phase": phase,
                "podIP": ip if phase == "Running" else "",
                "startTime": rfc3339(start_time or utcnow()),
                "containerStatuses": statuses,
            },
        }
        with self._lock:
            self._pods[(namespace, name)] = pod
        self._notify(("pods", namespace), "ADDED", pod)
        return pod

    def update_pod(self, namespace: str, name: str, **changes: Any) -> dict:
        with self._lock:
            pod = self._pods[(namespace, name)]
            if "phase" in changes:
                pod["status"]["phase"] = changes["phase"]
                if changes["phase"] != "Running":
                    pod["status"]["podIP"] = ""
            if "labels" in changes:
                pod["metadata"]["labels"] = dict(changes["labels"])
            if "node" in changes:
                pod["spec"]["nodeName"] = changes["node"]
            snapshot = copy.deepcopy(pod)
        self._notify(("pods", namespace), "MODIFIED", snapshot)
        return snapshot

    def delete_pod(self, namespace: str, name: str,
                   dry_run: bool = False) -> None:
        self._maybe_fail("delete_pod")
        with self._lock:
            if (namespace, name) not in self._pods:
                raise NotFound(f"pod {namespace}/{name} not found")
            if dry_run:
                return
            pod = self._pods.pop((namespace, name))
        self._notify(("pods", namespace), "DELETED", pod)

    # -- remediation verbs ---------------------------------------------------
    # Mutations mirror the KubeRestBackend surface (dry_run maps to the
    # server-side ``dryRun=All`` semantics: full validation, no state
    # change) and honor ``fail_next`` so executor breaker paths are
    # testable without a real API server.

    def add_statefulset(
        self,
        name: str,
        namespace: str = "default",
        replicas: int = 1,
        labels: dict[str, str] | None = None,
    ) -> dict:
        sts = {
            "metadata": {
                "name": name,
                "namespace": namespace,
                "uid": f"sts-{next(self._uid)}",
                "labels": dict(labels or {}),
                "creationTimestamp": rfc3339(utcnow()),
            },
            "spec": {"replicas": int(replicas)},
            "status": {"readyReplicas": int(replicas)},
        }
        with self._lock:
            self._statefulsets[(namespace, name)] = sts
        return sts

    def list_statefulsets(self, namespace: str) -> list[dict[str, Any]]:
        self._maybe_fail("list_statefulsets")
        with self._lock:
            return [
                copy.deepcopy(s)
                for (ns, _), s in sorted(self._statefulsets.items())
                if ns == namespace
            ]

    def get_statefulset_scale(self, namespace: str, name: str) -> int:
        self._maybe_fail("get_statefulset_scale")
        with self._lock:
            try:
                sts = self._statefulsets[(namespace, name)]
            except KeyError:
                raise NotFound(f"statefulset {namespace}/{name} not found")
            return int(sts["spec"].get("replicas", 0))

    def scale_statefulset(self, namespace: str, name: str, replicas: int,
                          dry_run: bool = False) -> None:
        self._maybe_fail("scale_statefulset")
        with self._lock:
            if (namespace, name) not in self._statefulsets:
                raise NotFound(f"statefulset {namespace}/{name} not found")
            if dry_run:
                return
            sts = self._statefulsets[(namespace, name)]
            sts["spec"]["replicas"] = int(replicas)
            sts["status"]["readyReplicas"] = int(replicas)

    def rollout_restart(self, namespace: str, name: str,
                        dry_run: bool = False) -> int:
        """Restart the workload's pods: every pod whose name starts with
        ``name`` returns to a fresh Running state (phase reset, restart
        counters zeroed) — the fake-cluster equivalent of the rollout
        replacing crashed pods with healthy ones.  Returns the pod count.
        """
        self._maybe_fail("rollout_restart")
        with self._lock:
            matched = [
                (ns, pn) for (ns, pn) in self._pods
                if ns == namespace and pn.startswith(name)
            ]
            if not matched:
                raise NotFound(
                    f"workload {namespace}/{name} matches no pods")
            if dry_run:
                return len(matched)
            snapshots = []
            for key in matched:
                pod = self._pods[key]
                pod["status"]["phase"] = "Running"
                pod["status"]["startTime"] = rfc3339(utcnow())
                for st in pod["status"].get("containerStatuses", []):
                    st["ready"] = True
                    st["restartCount"] = 0
                    st["state"] = {"running": {"startedAt": rfc3339(utcnow())}}
                snapshots.append(copy.deepcopy(pod))
        for snap in snapshots:
            self._notify(("pods", namespace), "MODIFIED", snap)
        return len(snapshots)

    def cordon_node(self, name: str, dry_run: bool = False) -> None:
        self._maybe_fail("cordon_node")
        with self._lock:
            if name not in self._nodes:
                raise NotFound(f"node {name} not found")
            if dry_run:
                return
            self._nodes[name].setdefault("spec", {})["unschedulable"] = True

    def add_service(
        self,
        name: str,
        namespace: str = "default",
        selector: dict[str, str] | None = None,
        ports: list[tuple[str, int, str]] | None = None,
        type_: str = "ClusterIP",
        cluster_ip: str = "",
    ) -> dict:
        uid = next(self._uid)
        svc = {
            "metadata": {
                "name": name,
                "namespace": namespace,
                "uid": f"svc-{uid}",
                "creationTimestamp": rfc3339(utcnow()),
            },
            "spec": {
                "type": type_,
                "clusterIP": cluster_ip or f"10.96.{uid % 250}.{uid % 200 + 1}",
                "selector": dict(selector or {}),
                "ports": [
                    {"name": n, "port": p, "protocol": proto}
                    for n, p, proto in (ports or [("http", 80, "TCP")])
                ],
            },
        }
        with self._lock:
            self._services[(namespace, name)] = svc
        self._notify(("services", namespace), "ADDED", svc)
        return svc

    def add_event(
        self,
        namespace: str = "default",
        type_: str = "Normal",
        reason: str = "",
        message: str = "",
        component: str = "kubelet",
        count: int = 1,
        involved_object: str = "",
        timestamp: datetime | None = None,
    ) -> dict:
        ev = {
            "metadata": {
                "name": f"ev-{next(self._uid)}",
                "namespace": namespace,
            },
            "type": type_,
            "reason": reason,
            "message": message,
            "source": {"component": component},
            "count": count,
            "lastTimestamp": rfc3339(timestamp or utcnow()),
            "involvedObject": {"name": involved_object, "namespace": namespace},
        }
        with self._lock:
            self._events.setdefault(namespace, []).append(ev)
        self._notify(("events", namespace), "ADDED", ev)
        return ev

    def add_network_policy(
        self,
        name: str,
        namespace: str = "default",
        pod_selector: dict[str, str] | None = None,
        ingress: list[dict] | None = None,
        egress: list[dict] | None = None,
    ) -> dict:
        pol = {
            "metadata": {"name": name, "namespace": namespace},
            "spec": {
                "podSelector": {"matchLabels": dict(pod_selector or {})},
                "ingress": ingress or [],
                "egress": egress or [],
            },
        }
        with self._lock:
            self._netpols[(namespace, name)] = pol
        return pol

    def set_pod_logs(self, namespace: str, name: str, lines: list[str]) -> None:
        with self._lock:
            self._logs[(namespace, name)] = list(lines)

    def set_node_usage(self, name: str, cpu: str, memory: str) -> None:
        with self._lock:
            self._node_usage[name] = {
                "metadata": {"name": name},
                "usage": {"cpu": cpu, "memory": memory},
            }

    def set_pod_usage(
        self,
        namespace: str,
        name: str,
        cpu: str,
        memory: str,
        containers: list[dict] | None = None,
    ) -> None:
        with self._lock:
            self._pod_usage[(namespace, name)] = {
                "metadata": {"name": name, "namespace": namespace},
                "containers": containers
                or [
                    {
                        "name": name.split("-")[0] or "main",
                        "usage": {"cpu": cpu, "memory": memory},
                    }
                ],
            }

    def set_exec_handler(self, handler: ExecHandler | None) -> None:
        self._exec_handler = handler

    # -- CRD builders --------------------------------------------------------

    def define_crd(
        self,
        group: str,
        kind: str,
        plural: str,
        singular: str = "",
        scope: str = "Namespaced",
        versions: list[str] | None = None,
        established: bool = True,
    ) -> dict:
        name = f"{plural}.{group}"
        crd = {
            "metadata": {
                "name": name,
                "creationTimestamp": rfc3339(utcnow()),
            },
            "spec": {
                "group": group,
                "scope": scope,
                "names": {
                    "kind": kind,
                    "plural": plural,
                    "singular": singular or kind.lower(),
                },
                "versions": [
                    {"name": v, "served": True, "storage": i == 0}
                    for i, v in enumerate(versions or ["v1"])
                ],
            },
            "status": {
                "conditions": (
                    [{"type": "Established", "status": "True"}] if established else []
                )
            },
        }
        with self._lock:
            self._crds[name] = crd
        self._notify(("crds",), "ADDED", crd)
        return crd

    # -- ClusterBackend implementation ---------------------------------------

    def server_version(self) -> str:
        self._maybe_fail("server_version")
        return self._version

    def list_nodes(self) -> list[dict]:
        self._maybe_fail("list_nodes")
        with self._lock:
            return copy.deepcopy(list(self._nodes.values()))

    def list_pods(self, namespace: str) -> list[dict]:
        self._maybe_fail("list_pods")
        with self._lock:
            return copy.deepcopy(
                [p for (ns, _), p in self._pods.items() if ns == namespace]
            )

    def list_services(self, namespace: str) -> list[dict]:
        self._maybe_fail("list_services")
        with self._lock:
            return copy.deepcopy(
                [s for (ns, _), s in self._services.items() if ns == namespace]
            )

    def list_events(self, namespace: str, limit: int = 0) -> list[dict]:
        self._maybe_fail("list_events")
        with self._lock:
            evs = copy.deepcopy(self._events.get(namespace, []))
        if limit and len(evs) > limit:
            evs = evs[-limit:]
        return evs

    def list_network_policies(self, namespace: str) -> list[dict]:
        self._maybe_fail("list_network_policies")
        with self._lock:
            return copy.deepcopy(
                [p for (ns, _), p in self._netpols.items() if ns == namespace]
            )

    def pod_logs(self, namespace: str, name: str, tail_lines: int = 100) -> str:
        self._maybe_fail("pod_logs")
        with self._lock:
            if (namespace, name) not in self._pods:
                raise NotFound(f"pod {namespace}/{name} not found")
            lines = self._logs.get((namespace, name), [])
        if tail_lines and len(lines) > tail_lines:
            lines = lines[-tail_lines:]
        return "\n".join(lines) + ("\n" if lines else "")

    # -- exec simulation -----------------------------------------------------

    def exec_in_pod(
        self, namespace: str, pod: str, command: list[str], timeout: float = 10.0
    ) -> tuple[str, str, int]:
        self._maybe_fail("exec_in_pod")
        with self._lock:
            if (namespace, pod) not in self._pods:
                raise NotFound(f"pod {namespace}/{pod} not found")
        if self._exec_handler is not None:
            return self._exec_handler(namespace, pod, command)
        return self._simulate_exec(namespace, pod, command)

    def _find_pod_by_ip(self, ip: str) -> dict | None:
        for p in self._pods.values():
            if p["status"].get("podIP") == ip:
                return p
        return None

    def _simulate_exec(
        self, namespace: str, pod: str, command: list[str]
    ) -> tuple[str, str, int]:
        """Synthesize ping/curl output the RTT parser understands."""
        prog = command[0] if command else ""
        with self._lock:
            src = self._pods[(namespace, pod)]
            target_ip = command[-1] if command else ""
            # curl URLs look like http://ip:port/
            m = re.search(r"(\d+\.\d+\.\d+\.\d+)", target_ip)
            tgt = self._find_pod_by_ip(m.group(1)) if m else None
            if tgt is None:
                return "", f"unknown host {target_ip}", 1
            same_node = src["spec"].get("nodeName") and src["spec"].get(
                "nodeName"
            ) == tgt["spec"].get("nodeName")
            rtt = self.same_node_rtt_ms if same_node else self.cross_node_rtt_ms
        if prog == "ping":
            n = 3
            if "-c" in command:
                n = int(command[command.index("-c") + 1])
            ip = m.group(1)
            lines = [f"PING {ip} ({ip}): 56 data bytes"]
            for i in range(n):
                lines.append(
                    f"64 bytes from {ip}: icmp_seq={i} ttl=64 "
                    f"time={rtt + 0.01 * i:.3f} ms"
                )
            lines += [
                f"--- {ip} ping statistics ---",
                f"{n} packets transmitted, {n} packets received, 0% packet loss",
                f"round-trip min/avg/max = {rtt:.3f}/{rtt:.3f}/{rtt:.3f} ms",
            ]
            return "\n".join(lines) + "\n", "", 0
        if prog == "curl":
            return f"{rtt / 1000.0:.6f}", "", 0
        return "", f"exec: {prog}: not found", 127

    # -- metrics.k8s.io ------------------------------------------------------

    def node_usage(self) -> list[dict]:
        self._maybe_fail("node_usage")
        if not self.metrics_server_available:
            raise ClusterError("metrics-server unavailable")
        with self._lock:
            out = []
            for name, node in self._nodes.items():
                if name in self._node_usage:
                    out.append(copy.deepcopy(self._node_usage[name]))
                else:
                    cap = node["status"]["capacity"]
                    out.append(
                        {
                            "metadata": {"name": name},
                            "usage": {
                                "cpu": f"{int(parse_cpu_millis(cap['cpu']) * 0.25)}m",
                                "memory": str(
                                    int(parse_mem_bytes(cap["memory"]) * 0.3)
                                ),
                            },
                        }
                    )
            return out

    def pod_usage(self, namespace: str) -> list[dict]:
        self._maybe_fail("pod_usage")
        if not self.metrics_server_available:
            raise ClusterError("metrics-server unavailable")
        with self._lock:
            out = []
            for (ns, name), pod in self._pods.items():
                if ns != namespace or pod["status"]["phase"] != "Running":
                    continue
                if (ns, name) in self._pod_usage:
                    out.append(copy.deepcopy(self._pod_usage[(ns, name)]))
                else:
                    out.append(
                        {
                            "metadata": {"name": name, "namespace": ns},
                            "containers": [
                                {"name": c["name"], "usage": {"cpu": "5m", "memory": "16Mi"}}
                                for c in pod["spec"]["containers"]
                            ],
                        }
                    )
            return out

    # -- watches -------------------------------------------------------------

    def _subscribe(self, topic: tuple) -> WatchStream:
        stream = WatchStream()
        with self._lock:
            self._watchers.setdefault(topic, []).append(stream)
        return stream

    def _notify(self, topic: tuple, event_type: str, obj: dict) -> None:
        with self._lock:
            streams = list(self._watchers.get(topic, []))
            # CR topics additionally fan out to all-namespace watchers
            if topic and topic[0] == "cr" and len(topic) == 4 and topic[3]:
                streams += self._watchers.get(topic[:3] + ("",), [])
        snapshot = copy.deepcopy(obj)
        for s in streams:
            s.put(event_type, snapshot)

    def watch(self, kind: str, namespace: str) -> WatchStream:
        self._maybe_fail("watch")
        if kind not in ("pods", "services", "events"):
            raise ClusterError(f"unknown watch kind {kind}")
        return self._subscribe((kind, namespace))

    def watch_crds(self) -> WatchStream:
        self._maybe_fail("watch_crds")
        return self._subscribe(("crds",))

    def watch_custom_resources(
        self, group: str, version: str, plural: str, namespace: str | None
    ) -> WatchStream:
        self._maybe_fail("watch_custom_resources")
        return self._subscribe(("cr", group, plural, namespace or ""))

    # -- custom resources ----------------------------------------------------

    def _crd_for(self, group: str, plural: str) -> dict:
        name = f"{plural}.{group}"
        crd = self._crds.get(name)
        if crd is None:
            raise NotFound(f"CRD {name} not defined")
        return crd

    def list_crds(self) -> list[dict]:
        self._maybe_fail("list_crds")
        with self._lock:
            return copy.deepcopy(list(self._crds.values()))

    def list_custom_resources(
        self, group: str, version: str, plural: str, namespace: str | None
    ) -> list[dict]:
        self._maybe_fail("list_custom_resources")
        with self._lock:
            self._crd_for(group, plural)
            out = []
            for (g, p, ns, _), obj in self._crs.items():
                if g == group and p == plural and (not namespace or ns == namespace):
                    out.append(copy.deepcopy(obj))
            return out

    def get_custom_resource(
        self, group: str, version: str, plural: str, namespace: str | None, name: str
    ) -> dict:
        self._maybe_fail("get_custom_resource")
        with self._lock:
            obj = self._crs.get((group, plural, namespace or "", name))
            if obj is None:
                raise NotFound(f"{plural}.{group} {namespace}/{name} not found")
            return copy.deepcopy(obj)

    def create_custom_resource(
        self,
        group: str,
        version: str,
        plural: str,
        namespace: str | None,
        body: dict,
    ) -> dict:
        self._maybe_fail("create_custom_resource")
        name = body["metadata"]["name"]
        key = (group, plural, namespace or "", name)
        with self._lock:
            crd = self._crd_for(group, plural)
            if key in self._crs:
                raise Conflict(f"{plural}.{group} {name} already exists")
            obj = copy.deepcopy(body)
            obj.setdefault("apiVersion", f"{group}/{version}")
            obj.setdefault("kind", crd["spec"]["names"]["kind"])
            md = obj["metadata"]
            if namespace:
                md["namespace"] = namespace
            md.setdefault("uid", f"cr-{next(self._uid)}")
            md["generation"] = 1
            md.setdefault("creationTimestamp", rfc3339(utcnow()))
            md["managedFields"] = [{"time": rfc3339(utcnow())}]
            self._crs[key] = obj
            snapshot = copy.deepcopy(obj)
        self._notify(("cr", group, plural, namespace or ""), "ADDED", snapshot)
        return snapshot

    def update_custom_resource(
        self,
        group: str,
        version: str,
        plural: str,
        namespace: str | None,
        body: dict,
    ) -> dict:
        self._maybe_fail("update_custom_resource")
        name = body["metadata"]["name"]
        key = (group, plural, namespace or "", name)
        with self._lock:
            old = self._crs.get(key)
            if old is None:
                raise NotFound(f"{plural}.{group} {name} not found")
            obj = copy.deepcopy(body)
            obj["metadata"]["generation"] = old["metadata"].get("generation", 1) + 1
            obj["metadata"].setdefault(
                "creationTimestamp", old["metadata"].get("creationTimestamp")
            )
            obj["metadata"]["managedFields"] = [{"time": rfc3339(utcnow())}]
            self._crs[key] = obj
            snapshot = copy.deepcopy(obj)
        self._notify(("cr", group, plural, namespace or ""), "MODIFIED", snapshot)
        return snapshot

    def update_custom_resource_status(
        self,
        group: str,
        version: str,
        plural: str,
        namespace: str | None,
        body: dict,
    ) -> dict:
        """Status-subresource write: only .status is applied."""
        self._maybe_fail("update_custom_resource_status")
        name = body["metadata"]["name"]
        key = (group, plural, namespace or "", name)
        with self._lock:
            obj = self._crs.get(key)
            if obj is None:
                raise NotFound(f"{plural}.{group} {name} not found")
            obj["status"] = copy.deepcopy(body.get("status", {}))
            snapshot = copy.deepcopy(obj)
        self._notify(("cr", group, plural, namespace or ""), "MODIFIED", snapshot)
        return snapshot

    def delete_custom_resource(
        self, group: str, version: str, plural: str, namespace: str | None, name: str
    ) -> None:
        with self._lock:
            obj = self._crs.pop((group, plural, namespace or "", name), None)
        if obj is not None:
            self._notify(("cr", group, plural, namespace or ""), "DELETED", obj)


def seed_demo_cluster(fake: FakeCluster) -> FakeCluster:
    """Populate a small 3-node demo cluster (the dev-mode default world).

    Mirrors the reference's k3d demo topology (docs/k3d-deployment.md:
    1 server + 2 agents) with a TPU node, app pods, a service, events and
    netpols so every API route returns non-trivial data without a cluster.
    """
    fake.add_node("k3d-demo-server-0", cpu="4", memory="8Gi", labels={"role": "server"})
    fake.add_node("k3d-demo-agent-0", cpu="8", memory="16Gi", labels={"role": "agent"})
    fake.add_node(
        "k3d-demo-agent-1",
        cpu="8",
        memory="16Gi",
        labels={"role": "agent"},
        tpu_chips=8,
    )
    fake.add_pod(
        "web-frontend-7d4b9c6f5-x2x1p",
        node="k3d-demo-agent-0",
        labels={"app": "web-frontend"},
        requests={"cpu": "100m", "memory": "128Mi"},
        limits={"cpu": "500m", "memory": "512Mi"},
    )
    fake.add_pod(
        "api-backend-6f5d8b7c9-k3k2m",
        node="k3d-demo-agent-1",
        labels={"app": "api-backend"},
        requests={"cpu": "200m", "memory": "256Mi"},
        limits={"cpu": "1", "memory": "1Gi"},
    )
    fake.add_pod(
        "coredns-5d78c9869d-abcde",
        namespace="kube-system",
        node="k3d-demo-server-0",
        labels={"k8s-app": "kube-dns"},
        image="coredns/coredns:1.11",
    )
    fake.add_service(
        "api-backend",
        selector={"app": "api-backend"},
        ports=[("http", 8080, "TCP")],
    )
    fake.add_event(
        reason="Scheduled",
        message="Successfully assigned default/web-frontend to k3d-demo-agent-0",
        component="default-scheduler",
        involved_object="web-frontend-7d4b9c6f5-x2x1p",
    )
    fake.set_pod_logs(
        "default",
        "api-backend-6f5d8b7c9-k3k2m",
        ["listening on :8080", "GET /healthz 200"],
    )
    fake.define_crd("monitoring.io", "UAVMetric", "uavmetrics")
    fake.define_crd("scheduler.io", "SchedulingRequest", "schedulingrequests")
    return fake
