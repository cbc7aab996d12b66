"""CLI smoke-test harness against a cluster backend.

Parity target: ``/root/reference/cmd/test-k8s/main.go:44-185`` —
connection test, cluster info, pod/service/event listings, a network
analysis between the first two pods, and a 10 s watch with a counting
event handler (``TestEventHandler``, main.go:16-42).
"""

from __future__ import annotations

import argparse
import logging
import sys
import time


class CountingHandler:
    """ref cmd/test-k8s/main.go:16-42."""

    def __init__(self) -> None:
        self.pod_events = 0
        self.service_events = 0
        self.events = 0
        self.crd_events = 0

    def on_pod_update(self, event_type, pod):
        self.pod_events += 1
        print(f"  [watch] pod {event_type}: {pod.namespace}/{pod.name}")

    def on_service_update(self, event_type, service):
        self.service_events += 1
        print(f"  [watch] service {event_type}: {service.namespace}/{service.name}")

    def on_event(self, event):
        self.events += 1
        print(f"  [watch] event: {event.reason} - {event.message}")

    def on_crd_event(self, event):
        self.crd_events += 1
        print(f"  [watch] CRD {event.type}: {event.kind}/{event.name}")


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description="cluster access smoke test")
    parser.add_argument("--config", default="")
    parser.add_argument("--cluster", choices=("fake", "kube"), default="fake")
    parser.add_argument("--kubeconfig", default="")
    parser.add_argument("--watch-seconds", type=float, default=10.0)
    args = parser.parse_args(argv)

    logging.basicConfig(level=logging.WARNING)

    from k8s_llm_monitor_tpu_torch.monitor.client import Client
    from k8s_llm_monitor_tpu_torch.monitor.config import load_config
    from k8s_llm_monitor_tpu_torch.monitor.network import NetworkAnalyzer
    from k8s_llm_monitor_tpu_torch.monitor.watcher import Watcher

    config = load_config(args.config or None)
    if args.cluster == "fake":
        from k8s_llm_monitor_tpu_torch.monitor.cluster import FakeCluster, seed_demo_cluster

        backend = seed_demo_cluster(FakeCluster())
    else:
        from k8s_llm_monitor_tpu_torch.monitor.kube_rest import KubeRestBackend

        backend = KubeRestBackend.from_kubeconfig(
            args.kubeconfig or config.k8s.kubeconfig or None
        )
    client = Client(backend, namespaces=config.k8s.watch_namespaces)

    print("=== 1. connection ===")
    version = client.test_connection()
    print(f"  connected: {version}")

    print("=== 2. cluster info ===")
    info = client.get_cluster_info()
    print(f"  {info}")

    print("=== 3. pods ===")
    pods = []
    for ns in client.namespaces():
        for p in client.get_pods(ns):
            pods.append(p)
            print(f"  {p.namespace}/{p.name} [{p.status}] on {p.node_name} ip={p.ip}")

    print("=== 4. services ===")
    for ns in client.namespaces():
        for s in client.get_services(ns):
            ports = ",".join(str(pp.port) for pp in s.ports)
            print(f"  {s.namespace}/{s.name} {s.type} {s.cluster_ip}:{ports}")

    print("=== 5. events ===")
    for ns in client.namespaces():
        for e in client.get_events(ns, limit=10):
            print(f"  [{e.type}] {e.reason}: {e.message}")

    if len(pods) >= 2:
        print("=== 6. network analysis (first two pods) ===")
        a, b = pods[0], pods[1]
        analysis = NetworkAnalyzer(client).analyze_pod_communication(
            f"{a.namespace}/{a.name}", f"{b.namespace}/{b.name}"
        )
        print(f"  status={analysis.status} confidence={analysis.confidence}")
        for issue in analysis.issues:
            print(f"  issue: {issue}")
        for sol in analysis.solutions:
            print(f"  solution: {sol}")

    print(f"=== 7. watching for {args.watch_seconds:.0f}s ===")
    handler = CountingHandler()
    watcher = Watcher(client, handler)
    watcher.start()
    time.sleep(args.watch_seconds)
    watcher.stop()
    print(
        f"  watch summary: pods={handler.pod_events} services="
        f"{handler.service_events} events={handler.events}"
    )
    print("=== all checks passed ===")
    return 0


if __name__ == "__main__":
    sys.exit(main())
