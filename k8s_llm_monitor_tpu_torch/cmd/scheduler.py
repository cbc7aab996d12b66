"""Scheduler controller entrypoint.

Parity target: ``/root/reference/cmd/scheduler/main.go:20-67`` — wires the
dynamic CRD client + controller with an ``-interval`` flag (default 15 s).
"""

from __future__ import annotations

import argparse
import logging
import signal
import sys
import threading


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description="UAV-aware scheduling controller")
    parser.add_argument("--config", default="", help="config YAML path")
    parser.add_argument("--interval", type=float, default=15.0)
    parser.add_argument(
        "--cluster", choices=("fake", "kube"), default="kube",
        help="cluster backend",
    )
    parser.add_argument("--kubeconfig", default="")
    parser.add_argument(
        "--once", action="store_true",
        help="run a single reconcile pass and exit (scripting/CI)")
    args = parser.parse_args(argv)

    logging.basicConfig(
        level=logging.INFO, format="%(asctime)s %(levelname)s %(name)s %(message)s"
    )
    log = logging.getLogger("cmd.scheduler")

    from k8s_llm_monitor_tpu_torch.monitor.client import Client
    from k8s_llm_monitor_tpu_torch.monitor.config import load_config
    from k8s_llm_monitor_tpu_torch.monitor.scheduler import (
        SchedulerConfig,
        SchedulerController,
    )

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
    ctrl = SchedulerController(client, SchedulerConfig(interval=args.interval))
    if args.once:
        n = ctrl.reconcile()
        log.info("one-shot reconcile processed %d request(s)", n)
        return 0
    ctrl.start()
    log.info("scheduler controller running (interval %.0fs)", args.interval)

    stop = threading.Event()
    signal.signal(signal.SIGINT, lambda *_: stop.set())
    signal.signal(signal.SIGTERM, lambda *_: stop.set())
    stop.wait()
    log.info("shutting down scheduler...")
    ctrl.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
