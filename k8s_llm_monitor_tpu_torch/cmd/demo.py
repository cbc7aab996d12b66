"""Demo walkthroughs, one subcommand per reference demo binary.

Parity target: ``/root/reference/cmd/demos/`` — ``debug-test`` (annotated
8-step stack walkthrough), ``live-monitor`` (continuous change stream +
stats ticker), ``network-demo`` (pod-communication analysis over the first
two pods), ``crd-demo`` (CRD discovery + CR event stream), ``rtt-demo``
(direct RTT probe).

Usage: ``python -m k8s_llm_monitor_tpu_torch.cmd.demo <name> [--seconds N]``
All demos run against the in-memory demo cluster by default so they work
on any laptop (the reference needs k3d for the same experience).
"""

from __future__ import annotations

import argparse
import sys
import threading
import time


def _client(args):
    from k8s_llm_monitor_tpu_torch.monitor.client import Client
    from k8s_llm_monitor_tpu_torch.monitor.cluster import FakeCluster, seed_demo_cluster

    if args.cluster == "kube":
        from k8s_llm_monitor_tpu_torch.monitor.config import load_config
        from k8s_llm_monitor_tpu_torch.monitor.kube_rest import KubeRestBackend

        cfg = load_config(None)
        backend = KubeRestBackend.from_kubeconfig(args.kubeconfig or None)
        return Client(backend, namespaces=cfg.k8s.watch_namespaces + ["kube-system"]), backend
    fake = seed_demo_cluster(FakeCluster())
    return Client(fake, namespaces=["default", "kube-system"]), fake


class _PrintingHandler:
    def on_pod_update(self, et, pod):
        print(f"[pod {et}] {pod.namespace}/{pod.name} status={pod.status}")

    def on_service_update(self, et, svc):
        print(f"[service {et}] {svc.namespace}/{svc.name}")

    def on_event(self, ev):
        print(f"[event] {ev.reason}: {ev.message}")

    def on_crd_event(self, ev):
        print(f"[crd {ev.type}] {ev.kind} {ev.namespace}/{ev.name}")


def demo_debug_test(args) -> None:
    """Step-by-step walkthrough (ref cmd/demos/debug-test)."""
    client, fake = _client(args)
    print("step 1: connect ->", client.test_connection())
    print("step 2: cluster info ->", client.get_cluster_info())
    print("step 3: pods ->", [p.name for p in client.get_pods("default")])
    print("step 4: services ->", [s.name for s in client.get_services("default")])
    print("step 5: events ->", [e.reason for e in client.get_events("default", 5)])
    print("step 6: CRDs ->", [c["metadata"]["name"] for c in client.backend.list_crds()])
    from k8s_llm_monitor_tpu_torch.monitor.watcher import Watcher

    print(f"step 7: watching for {args.seconds:.0f}s...")
    w = Watcher(client, _PrintingHandler())
    w.start()
    if args.cluster == "fake":
        fake.add_pod("debug-demo-pod", node="k3d-demo-agent-0")
    time.sleep(args.seconds)
    w.stop()
    print("step 8: done")


def demo_live_monitor(args) -> None:
    """Continuous change stream + stats ticker (ref cmd/demos/live-monitor)."""
    client, fake = _client(args)
    from k8s_llm_monitor_tpu_torch.monitor.watcher import CRDWatcher, Watcher

    handler = _PrintingHandler()
    w = Watcher(client, handler)
    cw = CRDWatcher(client, handler)
    w.start()
    cw.start()

    stop = threading.Event()

    def stats():
        while not stop.wait(min(30.0, args.seconds / 2 or 5)):
            info = client.get_cluster_info()
            print(f"[stats] nodes={info['nodes']} pods={info['pods']}")

    t = threading.Thread(target=stats, daemon=True)
    t.start()
    if args.cluster == "fake":
        fake.add_pod("live-pod-1", node="k3d-demo-agent-0")
        time.sleep(args.seconds / 3)
        fake.update_pod("default", "live-pod-1", phase="Failed")
        fake.add_event(type_="Warning", reason="Failed", message="demo failure")
    time.sleep(args.seconds)
    stop.set()
    w.stop()
    cw.stop()


def demo_network(args) -> None:
    """Pod-communication analysis over the first two pods
    (ref cmd/demos/network-demo)."""
    client, _ = _client(args)
    from k8s_llm_monitor_tpu_torch.monitor.network import NetworkAnalyzer

    pods = client.get_pods("default")
    if len(pods) < 2:
        print("need at least two pods in default")
        return
    a, b = pods[0], pods[1]
    print(f"analyzing {a.name} <-> {b.name} ...")
    res = NetworkAnalyzer(client).analyze_pod_communication(
        f"default/{a.name}", f"default/{b.name}"
    )
    print(f"status: {res.status} (confidence {res.confidence})")
    for i in res.issues:
        print(f"  issue: {i}")
    for s in res.solutions:
        print(f"  solution: {s}")


def demo_crd(args) -> None:
    """CRD discovery + CR stream (ref cmd/demos/crd-demo:107-141)."""
    client, fake = _client(args)
    from k8s_llm_monitor_tpu_torch.monitor.watcher import CRDWatcher

    cw = CRDWatcher(client, _PrintingHandler())
    cw.start()
    time.sleep(0.2)
    print("established CRDs:")
    for crd in cw.get_crds():
        print(f"  {crd.name} (kind={crd.kind}, scope={crd.scope})")
    if args.cluster == "fake":
        from k8s_llm_monitor_tpu_torch.monitor.models import UAVReport

        client.upsert_uav_metric(
            "",
            UAVReport(node_name="demo-node", uav_id="uav-demo",
                      state={"battery": {"remaining_percent": 88.0}}),
        )
    time.sleep(args.seconds)
    cw.stop()


def demo_rtt(args) -> None:
    """Direct RTT probe (ref cmd/demos/rtt-demo)."""
    client, _ = _client(args)
    from k8s_llm_monitor_tpu_torch.monitor.rtt import RTTTester

    pods = client.get_pods("default")
    if len(pods) < 2:
        print("need at least two pods in default")
        return
    a, b = pods[0], pods[1]
    res = RTTTester(client).test_pod_connectivity(
        f"default/{a.name}", f"default/{b.name}"
    )
    print(f"{a.name} <-> {b.name}:")
    for r in res.rtt_results:
        status = f"{r.rtt_ms:.2f}ms" if r.success else f"FAILED ({r.error_message})"
        print(f"  {r.method}: {status}")
    print(
        f"  avg {res.average_rtt_ms:.2f}ms, success {res.success_rate:.0f}%, "
        f"grade {res.latency_assessment}"
    )


DEMOS = {
    "debug-test": demo_debug_test,
    "live-monitor": demo_live_monitor,
    "network-demo": demo_network,
    "crd-demo": demo_crd,
    "rtt-demo": demo_rtt,
}


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description="framework demos")
    parser.add_argument("demo", choices=sorted(DEMOS))
    parser.add_argument("--seconds", type=float, default=5.0)
    parser.add_argument("--cluster", choices=("fake", "kube"), default="fake")
    parser.add_argument("--kubeconfig", default="")
    args = parser.parse_args(argv)
    DEMOS[args.demo](args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
