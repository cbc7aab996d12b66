"""Per-node UAV agent: telemetry HTTP API + report push loop.

Parity target: ``/root/reference/cmd/uav-agent/main.go`` — the :9090 HTTP
surface (``GET /health``, ``GET /api/v1/{state,gps,attitude,battery,
flight}``, ``POST /api/v1/command/{arm,disarm,takeoff,land,rtl,mode}``,
main.go:84-280) and the report loop POSTing a full ``UAVReport`` to
``<master>/api/v1/uav/report`` on a ticker with the first report sent
immediately (main.go:326-416). Identity comes from flags/env
(NODE_NAME/NODE_IP/MASTER_URL/REPORT_INTERVAL, main.go:27-63).
"""

from __future__ import annotations

import json
import logging
import threading
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any

from k8s_llm_monitor_tpu_torch.monitor.models import rfc3339, utcnow
from k8s_llm_monitor_tpu_torch.monitor.uav import MAVLinkSimulator

logger = logging.getLogger("monitor.agent")


class UAVAgent:
    def __init__(
        self,
        node_name: str,
        node_ip: str = "",
        uav_id: str = "",
        port: int = 9090,
        master_url: str = "",
        report_interval: float = 10.0,
        poster=None,  # injectable for tests: poster(url, payload_dict)
    ) -> None:
        self.node_name = node_name
        self.node_ip = node_ip
        self.uav_id = uav_id or f"uav-{node_name}"
        self.port = port
        self.master_url = master_url.rstrip("/")
        self.report_interval = report_interval
        self.simulator = MAVLinkSimulator(self.uav_id, node_name)
        self._poster = poster or self._http_post
        self._httpd: ThreadingHTTPServer | None = None
        self._http_thread: threading.Thread | None = None
        self._report_thread: threading.Thread | None = None
        self._stop = threading.Event()
        self.reports_sent = 0
        self.report_errors = 0

    # -- lifecycle -------------------------------------------------------------

    def start(self) -> None:
        self.simulator.start()
        handler = _make_handler(self)
        self._httpd = ThreadingHTTPServer(("0.0.0.0", self.port), handler)
        self.port = self._httpd.server_address[1]
        self._http_thread = threading.Thread(
            target=self._httpd.serve_forever, name="uav-agent-http", daemon=True
        )
        self._http_thread.start()
        if self.master_url:
            self._report_thread = threading.Thread(
                target=self._report_loop, name="uav-agent-report", daemon=True
            )
            self._report_thread.start()
        logger.info(
            "uav-agent for %s serving on :%d (master: %s)",
            self.node_name,
            self.port,
            self.master_url or "<none>",
        )

    def stop(self) -> None:
        self._stop.set()
        self.simulator.stop()
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        for t in (self._http_thread, self._report_thread):
            if t is not None:
                t.join(timeout=5)
        self._http_thread = self._report_thread = None

    # -- report push (ref main.go:326-416) ---------------------------------------

    def build_report(self) -> dict[str, Any]:
        state = self.simulator.get_state()
        report: dict[str, Any] = {
            "node_name": self.node_name,
            "uav_id": self.uav_id,
            "source": "agent",
            "status": "active",
            "timestamp": rfc3339(utcnow()),
            "heartbeat_interval_seconds": int(self.report_interval),
            "state": state,
        }
        if self.node_ip:
            report["node_ip"] = self.node_ip
        return report

    def send_report(self) -> bool:
        url = f"{self.master_url}/api/v1/uav/report"
        try:
            self._poster(url, self.build_report())
            self.reports_sent += 1
            return True
        except Exception as exc:  # noqa: BLE001 — loop must survive outages
            self.report_errors += 1
            logger.warning("report to %s failed: %s", url, exc)
            return False

    def _report_loop(self) -> None:
        self.send_report()  # first report immediately (ref main.go:337)
        while not self._stop.wait(self.report_interval):
            self.send_report()

    @staticmethod
    def _http_post(url: str, payload: dict[str, Any]) -> None:
        req = urllib.request.Request(
            url,
            data=json.dumps(payload).encode(),
            headers={"Content-Type": "application/json"},
            method="POST",
        )
        with urllib.request.urlopen(req, timeout=10) as resp:
            resp.read()


def _make_handler(agent: UAVAgent) -> type[BaseHTTPRequestHandler]:
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt: str, *args: Any) -> None:
            logger.debug("%s %s", self.address_string(), fmt % args)

        def _json(self, payload: Any, status: int = 200) -> None:
            body = json.dumps(payload).encode()
            self.send_response(status)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self) -> None:  # noqa: N802
            state = agent.simulator.get_state()
            routes = {
                "/health": lambda: {
                    "status": "healthy",
                    "uav_id": agent.uav_id,
                    "node_name": agent.node_name,
                    "timestamp": rfc3339(utcnow()),
                },
                "/api/v1/state": lambda: state,
                "/api/v1/gps": lambda: state["gps"],
                "/api/v1/attitude": lambda: state["attitude"],
                "/api/v1/battery": lambda: state["battery"],
                "/api/v1/flight": lambda: state["flight"],
            }
            fn = routes.get(self.path.split("?")[0])
            if fn is None:
                return self._json({"error": "not found"}, 404)
            self._json(fn())

        def do_POST(self) -> None:  # noqa: N802
            path = self.path.split("?")[0]
            if not path.startswith("/api/v1/command/"):
                return self._json({"error": "not found"}, 404)
            command = path[len("/api/v1/command/") :]
            length = int(self.headers.get("Content-Length", 0) or 0)
            try:
                body = json.loads(self.rfile.read(length)) if length else {}
            except json.JSONDecodeError:
                return self._json({"error": "invalid JSON body"}, 400)
            sim = agent.simulator
            ok, detail = True, ""
            if command == "arm":
                ok = sim.arm()
                detail = "" if ok else "arm rejected: no 3D GPS fix"
            elif command == "disarm":
                sim.disarm()
            elif command == "takeoff":
                ok = sim.take_off(float(body.get("altitude", 50.0)))
                detail = "" if ok else "takeoff rejected: not armed"
            elif command == "land":
                sim.land()
            elif command == "rtl":
                sim.return_to_launch()
            elif command == "mode":
                mode = body.get("mode", "")
                if not mode:
                    return self._json({"error": "mode is required"}, 400)
                sim.set_flight_mode(mode)
            else:
                return self._json({"error": f"unknown command {command}"}, 404)
            payload = {
                "status": "success" if ok else "rejected",
                "command": command,
                "timestamp": rfc3339(utcnow()),
            }
            if detail:
                payload["message"] = detail
            self._json(payload, 200 if ok else 409)

    return Handler
