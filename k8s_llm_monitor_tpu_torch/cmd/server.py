"""Monitor API server entrypoint over the port's engine.

The JAX package's ``cmd/server.py``: config load, cluster client with
dev-mode degradation, metrics manager start, the diagnosis watcher, route
registration and serve, and a graceful drain on SIGTERM/SIGINT.

Cluster selection:
- ``--cluster fake``   : in-memory demo cluster (runs anywhere)
- ``--cluster none``   : no cluster at all (pure degraded mode)
- ``--cluster kube``   : real API server via kubeconfig/in-cluster
                         (stdlib REST client, monitor/kube_rest.py); an
                         unreachable one warns and boots in dev mode

``--device`` names where the model runs with ``llm.provider="tpu"``
(default ``cuda``; ``cpu`` runs the plain PyTorch path).  The weights are
random ones for the preset ``llm.tpu.model``, or a local HF safetensors
checkpoint (``LLM_TPU_CHECKPOINT=<dir>``; its tokenizer needs
``transformers``), bf16, int8 or W8A8 (``LLM_TPU_QUANTIZE``, ``w8a8`` by
default).  ``--role router`` is not ported yet (ROADMAP A8).

The monitor's default config (``load_config(None)``: telemetry and
remediation on) boots as it is.

Usage:
    python -m k8s_llm_monitor_tpu_torch.cmd.server --cluster fake --port 8081
    python -m k8s_llm_monitor_tpu_torch.cmd.server --config config.yaml
"""

from __future__ import annotations

import argparse
import logging
import signal
import sys
import threading


def _graceful_shutdown(srv, grace_s: float, log: logging.Logger) -> None:
    """SIGTERM handover: stop admitting, drain within the grace window,
    seal the journal, then unblock ``serve_forever`` so the process exits.

    Readiness flips to 503 first (via the supervisor's TERMINATING state /
    health DRAINING) so traffic stops arriving while inflight generations
    finish.
    """
    from k8s_llm_monitor_tpu_torch.observability.flight import (
        get_flight_recorder,
    )

    # Last-gasp artifact before teardown mutates any in-flight state; a
    # dump failure must never block the drain.
    rec = get_flight_recorder()
    rec.note("sigterm", grace_s=grace_s)
    rec.dump("sigterm", extra={"grace_s": grace_s})
    srv.draining = True
    if srv.signals is not None:
        srv.signals.stop()
        log.info("signal scraper stopped")
    watcher = getattr(srv, "diagnosis_watcher", None)
    if watcher is not None:
        watcher.stop()
        log.info("diagnosis watcher stopped")
    if srv.diagnosis is not None:
        srv.diagnosis.stop()
        log.info("diagnosis pipeline stopped")
    sup = srv.engine_supervisor()
    if sup is not None:
        drained = sup.shutdown(grace_s=grace_s)
        log.info("engine supervisor shut down (drained=%s, journal sealed)",
                 drained)
    else:
        svc = srv.engine_service()
        if svc is not None:
            svc.drain(timeout=grace_s)
            svc.stop(timeout=5.0)
            log.info("engine service drained and stopped")
    if srv.manager is not None:
        srv.manager.stop()
    srv.request_shutdown()


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        description="k8s-llm-monitor server (PyTorch port)")
    parser.add_argument("--config", default="", help="config YAML path")
    parser.add_argument("--host", default=None)
    parser.add_argument("--port", type=int, default=None)
    parser.add_argument(
        "--cluster",
        choices=("fake", "kube", "none"),
        default="fake",
        help="cluster backend (default: fake demo cluster)",
    )
    parser.add_argument("--kubeconfig", default="",
                        help="kubeconfig path for --cluster kube")
    parser.add_argument(
        "--llm",
        default="",
        help="override llm.provider (tpu | openai | template)",
    )
    parser.add_argument(
        "--role",
        choices=("replica", "router"),
        default="replica",
        help="replica: serve a local engine (default); router: not ported",
    )
    parser.add_argument(
        "--device",
        default="cuda",
        help="device of the in-tree engine (default cuda; cpu runs the "
             "plain PyTorch path)",
    )
    parser.add_argument(
        "--mesh-backend",
        choices=("nccl", "gloo"),
        default="nccl",
        help="collectives of an llm.tpu.mesh_shape mesh: nccl (a card per "
             "rank) or gloo (host-staged; ranks may share a card; the "
             "CPU's)",
    )
    args = parser.parse_args(argv)

    if args.role == "router":
        raise NotImplementedError(
            "--role router: the fleet router is not ported (ROADMAP A8)")

    from k8s_llm_monitor_tpu_torch.monitor.config import load_config
    from k8s_llm_monitor_tpu_torch.monitor.server import build_server

    config = load_config(args.config or None)
    logging.basicConfig(
        level=logging.DEBUG if config.server.debug else logging.INFO,
        format="%(asctime)s %(levelname)s %(name)s %(message)s",
    )
    log = logging.getLogger("cmd.server")
    if args.host is not None:
        config.server.host = args.host
    if args.port is not None:
        config.server.port = args.port
    if args.llm:
        config.llm.provider = args.llm

    backend = None
    if args.cluster == "fake":
        from k8s_llm_monitor_tpu_torch.monitor.cluster import (
            FakeCluster,
            seed_demo_cluster,
        )

        backend = seed_demo_cluster(FakeCluster())
        log.info("using in-memory demo cluster")
    elif args.cluster == "kube":
        try:
            from k8s_llm_monitor_tpu_torch.monitor.kube_rest import (
                KubeRestBackend,
            )

            backend = KubeRestBackend.from_kubeconfig(
                args.kubeconfig or config.k8s.kubeconfig or None
            )
            backend.server_version()  # fail fast if unreachable
        except Exception as exc:  # noqa: BLE001 — dev-mode degradation
            log.warning("cluster unreachable (%s) - development mode", exc)
            backend = None

    srv = build_server(config, backend=backend, device=args.device,
                       mesh_backend=args.mesh_backend)
    if srv.manager is not None:
        srv.manager.start()
        log.info(
            "metrics manager started (interval %ds)", config.metrics.collect_interval
        )

    # Standing watcher -> LLM diagnosis loop: the resource watcher feeds the
    # pipeline's EventHandler; the pipeline's worker thread (started with
    # the HTTP server) turns event bursts into constrained root-cause
    # verdicts behind GET /api/v1/diagnoses.
    srv.diagnosis_watcher = None
    if srv.diagnosis is not None and srv.client is not None:
        from k8s_llm_monitor_tpu_torch.monitor.watcher import Watcher

        srv.diagnosis_watcher = Watcher(
            srv.client, srv.diagnosis.handler,
            namespaces=config.k8s.watch_namespaces)
        srv.diagnosis_watcher.start()
        log.info("diagnosis watcher started (burst threshold %d in %.0fs)",
                 config.diagnosis.burst_threshold, config.diagnosis.window_s)

    # SIGTERM / SIGINT: flip readiness to 503, drain inflight generations
    # within the grace window, seal the request journal, exit.  The work
    # runs on a helper thread: httpd.shutdown() deadlocks when called from
    # the thread running serve_forever, and signal handlers run exactly
    # there.
    shutdown_started = threading.Event()

    def _on_signal(signum, frame):  # noqa: ARG001 — signal API
        if shutdown_started.is_set():
            log.warning("second signal %d: exiting immediately", signum)
            raise SystemExit(128 + signum)
        shutdown_started.set()
        log.info("signal %d: graceful shutdown (grace %.0fs)",
                 signum, config.lifecycle.drain_grace_s)
        threading.Thread(
            target=_graceful_shutdown,
            args=(srv, config.lifecycle.drain_grace_s, log),
            name="graceful-shutdown",
            daemon=True,
        ).start()

    signal.signal(signal.SIGTERM, _on_signal)
    signal.signal(signal.SIGINT, _on_signal)

    try:
        srv.serve_forever()
    finally:
        if not shutdown_started.is_set():
            if srv.signals is not None:
                srv.signals.stop()
            if srv.diagnosis_watcher is not None:
                srv.diagnosis_watcher.stop()
            if srv.diagnosis is not None:
                srv.diagnosis.stop()
            sup = srv.engine_supervisor()
            if sup is not None:
                sup.shutdown(grace_s=0.0)
        if srv.manager is not None:
            srv.manager.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
