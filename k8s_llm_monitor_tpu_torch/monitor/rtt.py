"""In-pod exec RTT probes (ping + HTTP timing).

Parity target: ``reference/internal/k8s/rtt_tester.go`` —
bidirectional ping (:73-91), conditional HTTP timing for HTTP-looking
targets (:94-105, :300-320), in-pod command execution over the exec
subresource (:170-216; here: ``ClusterBackend.exec_in_pod``), output
parsing (:219-297) and stats/latency grading (:323-369).
"""

from __future__ import annotations

import logging
import statistics

from k8s_llm_monitor_tpu_torch.monitor.client import Client
from k8s_llm_monitor_tpu_torch.monitor.cluster import ClusterError
from k8s_llm_monitor_tpu_torch.monitor.models import (
    NetworkTestResult,
    PodInfo,
    RTTResult,
    utcnow,
)

logger = logging.getLogger("monitor.rtt")

PING_COUNT = 3
PING_TIMEOUT_S = 5
HTTP_TIMEOUT_S = 5
HTTP_APP_HINTS = ("nginx", "httpd", "apache", "web")


def parse_pod_ref(pod_ref: str) -> tuple[str, str]:
    """'ns/name' → (ns, name); bare name → ('default', name).

    ref network.go:85-91 parsePodName.
    """
    parts = pod_ref.split("/")
    if len(parts) == 2:
        return parts[0], parts[1]
    return "default", parts[0]


def parse_ping_output(output: str) -> tuple[float, int, float]:
    """(rtt average ms, sample count, packet loss %) from ping stdout.

    Per-line ``time=`` extraction + packet-loss line scan, matching ref
    rtt_tester.go:219-297.
    """
    rtts: list[float] = []
    loss = 0.0
    for line in output.splitlines():
        if "time=" in line and "ms" in line:
            try:
                token = line.split("time=")[1].split()[0]
                rtts.append(float(token.removesuffix("ms")))
            except (IndexError, ValueError):
                pass
        if "packet loss" in line:
            for part in line.split():
                if "%" in part:
                    try:
                        loss = float(part.rstrip("%,"))
                    except ValueError:
                        pass
    avg = statistics.fmean(rtts) if rtts else 0.0
    return avg, len(rtts), loss


def is_http_service(pod: PodInfo) -> bool:
    """Label/image heuristic from ref rtt_tester.go:300-320."""
    app = pod.labels.get("app", "").lower()
    if any(h in app for h in HTTP_APP_HINTS):
        return True
    for c in pod.containers:
        img = c.image.lower()
        if "nginx" in img or "httpd" in img:
            return True
    return False


def assess_latency(rtt_ms: float) -> str:
    """Grading bands from ref rtt_tester.go:354-369."""
    if rtt_ms == 0:
        return "unknown"
    if rtt_ms < 1:
        return "excellent"
    if rtt_ms < 5:
        return "good"
    if rtt_ms < 50:
        return "fair"
    if rtt_ms < 100:
        return "poor"
    return "very_poor"


class RTTTester:
    """Active probes executed inside the source pod via the backend exec seam."""

    def __init__(self, client: Client) -> None:
        self.client = client

    def test_pod_connectivity(self, pod_a: str, pod_b: str) -> NetworkTestResult:
        ns_a, name_a = parse_pod_ref(pod_a)
        ns_b, name_b = parse_pod_ref(pod_b)
        info_a = self.client.get_pod(ns_a, name_a)
        info_b = self.client.get_pod(ns_b, name_b)

        result = NetworkTestResult(pod_a=pod_a, pod_b=pod_b)

        # bidirectional ping (ref rtt_tester.go:73-91)
        if info_b.ip:
            r = self._ping_from_pod(info_a, info_b.ip)
            r.method = "ping"
            result.rtt_results.append(r)
            result.test_count += 1
        if info_a.ip:
            r = self._ping_from_pod(info_b, info_a.ip)
            r.method = "ping_reverse"
            result.rtt_results.append(r)
            result.test_count += 1

        # HTTP timing when the target looks like an HTTP service
        if is_http_service(info_b) and info_b.ip:
            r = self._http_from_pod(info_a, info_b.ip, 80)
            r.method = "http"
            result.rtt_results.append(r)
            result.test_count += 1

        self._calculate_stats(result)
        return result

    # -- probes ---------------------------------------------------------------

    def _ping_from_pod(self, pod: PodInfo, target_ip: str) -> RTTResult:
        result = RTTResult(timestamp=utcnow(), method="ping")
        cmd = ["ping", "-c", str(PING_COUNT), "-W", str(PING_TIMEOUT_S), target_ip]
        try:
            stdout, stderr, rc = self.client.exec_in_pod(
                pod.namespace, pod.name, cmd, timeout=PING_TIMEOUT_S * PING_COUNT
            )
        except ClusterError as exc:
            result.error_message = f"ping exec failed: {exc}"
            logger.error("ping from %s to %s failed: %s", pod.name, target_ip, exc)
            return result
        if rc != 0 and not stdout:
            result.error_message = stderr.strip() or f"ping exited {rc}"
            return result
        rtt, count, loss = parse_ping_output(stdout)
        if count > 0:
            result.rtt_ms = rtt
            result.success = True
        result.packet_loss = loss
        return result

    def _http_from_pod(self, pod: PodInfo, target_ip: str, port: int) -> RTTResult:
        result = RTTResult(timestamp=utcnow(), method="http")
        cmd = [
            "curl",
            "-s",
            "-o",
            "/dev/null",
            "-w",
            "%{time_total}",
            "-m",
            str(HTTP_TIMEOUT_S),
            f"http://{target_ip}:{port}",
        ]
        try:
            stdout, stderr, rc = self.client.exec_in_pod(
                pod.namespace, pod.name, cmd, timeout=HTTP_TIMEOUT_S + 2
            )
        except ClusterError as exc:
            result.error_message = f"http exec failed: {exc}"
            logger.error("curl from %s to %s failed: %s", pod.name, target_ip, exc)
            return result
        if rc != 0:
            # curl prints %{time_total} even on failure (e.g. connection
            # refused) — a nonzero exit must not count as a timed success
            result.error_message = stderr.strip() or f"curl exited {rc}"
            return result
        try:
            # curl -w time_total prints seconds (ref rtt_tester.go:253-264)
            result.rtt_ms = float(stdout.strip()) * 1000.0
            result.success = True
        except ValueError:
            result.error_message = stderr.strip() or f"unparseable curl output {stdout!r}"
        return result

    # -- stats (ref rtt_tester.go:323-351) -------------------------------------

    def _calculate_stats(self, result: NetworkTestResult) -> None:
        if not result.rtt_results:
            result.latency_assessment = "unknown"
            return
        successes = [r for r in result.rtt_results if r.success]
        if successes:
            result.average_rtt_ms = statistics.fmean(r.rtt_ms for r in successes)
            result.success_rate = len(successes) / len(result.rtt_results) * 100.0
        result.latency_assessment = assess_latency(result.average_rtt_ms)
