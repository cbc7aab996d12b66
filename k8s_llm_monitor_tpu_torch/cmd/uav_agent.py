"""UAV agent entrypoint (per-node DaemonSet process).

Parity target: ``/root/reference/cmd/uav-agent/main.go:22-63`` — flags
``-port``/``-master-url``/``-report-interval`` with env fallbacks
``MASTER_URL``/``REPORT_INTERVAL``/``NODE_NAME``/``NODE_IP`` (the
DaemonSet injects node identity via fieldRef, ref
deployments/uav-agent-daemonset.yaml).
"""

from __future__ import annotations

import argparse
import logging
import os
import signal
import sys
import threading


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description="per-node UAV telemetry agent")
    parser.add_argument("--port", type=int, default=9090)
    parser.add_argument("--master-url", default=os.environ.get("MASTER_URL", ""))
    parser.add_argument(
        "--report-interval",
        type=float,
        default=float(os.environ.get("REPORT_INTERVAL", "10")),
    )
    parser.add_argument("--node-name", default=os.environ.get("NODE_NAME", ""))
    parser.add_argument("--node-ip", default=os.environ.get("NODE_IP", ""))
    args = parser.parse_args(argv)

    logging.basicConfig(
        level=logging.INFO, format="%(asctime)s %(levelname)s %(name)s %(message)s"
    )
    log = logging.getLogger("cmd.uav-agent")
    node_name = args.node_name or os.uname().nodename

    from k8s_llm_monitor_tpu_torch.monitor.agent import UAVAgent

    agent = UAVAgent(
        node_name=node_name,
        node_ip=args.node_ip,
        port=args.port,
        master_url=args.master_url,
        report_interval=args.report_interval,
    )
    agent.start()
    log.info(
        "uav-agent on %s: telemetry :%d, reporting to %s every %.0fs",
        node_name,
        agent.port,
        args.master_url or "<disabled>",
        args.report_interval,
    )

    stop = threading.Event()
    signal.signal(signal.SIGINT, lambda *_: stop.set())
    signal.signal(signal.SIGTERM, lambda *_: stop.set())
    stop.wait()
    log.info("shutting down uav-agent...")
    agent.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
