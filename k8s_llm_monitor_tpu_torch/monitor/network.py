"""Pod-communication analyzer — the rule-based diagnosis pipeline.

Parity target: ``reference/internal/k8s/network.go:34-315`` — the
5-check pipeline (pod status, network-policy overlap, service targeting,
CoreDNS health, live RTT probe) accumulating ``issues``/``solutions`` into
a ``CommunicationAnalysis``, with the reference's final-status rule
(no issues → connected/0.9 else disconnected/0.7, network.go:306-315).

This evidence also feeds the Analysis Engine (analysis.py): the LLM
receives the raw check findings and generates the root-cause narrative the
reference never implemented.
"""

from __future__ import annotations

import logging

from k8s_llm_monitor_tpu_torch.monitor.client import Client
from k8s_llm_monitor_tpu_torch.monitor.cluster import ClusterError
from k8s_llm_monitor_tpu_torch.monitor.models import (
    CommunicationAnalysis,
    NetworkPolicyInfo,
    PodInfo,
    ServiceInfo,
)
from k8s_llm_monitor_tpu_torch.monitor.rtt import RTTTester, parse_pod_ref

logger = logging.getLogger("monitor.network")


def _selector_matches(selector: dict[str, str], labels: dict[str, str]) -> bool:
    """Simplified label match (ref network.go:199-208, 254-261)."""
    return any(labels.get(k) == v for k, v in selector.items())


class NetworkAnalyzer:
    def __init__(self, client: Client, enable_rtt: bool = True) -> None:
        self.client = client
        self.rtt_tester = RTTTester(client)
        self.enable_rtt = enable_rtt

    def analyze_pod_communication(
        self, pod_a: str, pod_b: str
    ) -> CommunicationAnalysis:
        ns_a, name_a = parse_pod_ref(pod_a)
        ns_b, name_b = parse_pod_ref(pod_b)
        info_a = self.client.get_pod(ns_a, name_a)
        info_b = self.client.get_pod(ns_b, name_b)

        analysis = CommunicationAnalysis(pod_a=pod_a, pod_b=pod_b, status="unknown")

        self._check_pod_status(info_a, analysis)
        self._check_pod_status(info_b, analysis)
        self._check_network_policies(info_a, info_b, analysis)
        self._check_service_connectivity(info_a, info_b, analysis)
        self._check_dns_connectivity(analysis)
        if self.enable_rtt:
            self._check_rtt_connectivity(pod_a, pod_b, analysis)
        self._determine_final_status(analysis)
        return analysis

    # -- check 1: pod running (ref network.go:104-111) -------------------------

    def _check_pod_status(
        self, pod: PodInfo, analysis: CommunicationAnalysis
    ) -> None:
        if pod.status != "Running":
            analysis.issues.append(
                f"Pod {pod.namespace}/{pod.name} is not running (status: {pod.status})"
            )
            analysis.solutions.append(
                f"Check Pod {pod.namespace}/{pod.name} logs and events for issues"
            )

    # -- check 2: network policies (ref network.go:114-208) --------------------

    def _check_network_policies(
        self, pod_a: PodInfo, pod_b: PodInfo, analysis: CommunicationAnalysis
    ) -> None:
        policies: list[NetworkPolicyInfo] = []
        for ns in {pod_a.namespace, pod_b.namespace}:
            try:
                policies.extend(self.client.get_network_policies(ns))
            except ClusterError as exc:
                logger.warning("failed to get network policies for %s: %s", ns, exc)
                return
        for policy in policies:
            if _selector_matches(policy.pod_selector, pod_a.labels) or _selector_matches(
                policy.pod_selector, pod_b.labels
            ):
                analysis.issues.append(
                    f"Network policy {policy.namespace}/{policy.name} may affect communication"
                )
                analysis.solutions.append(
                    f"Review network policy {policy.namespace}/{policy.name} rules"
                )

    # -- check 3: service targets pod B (ref network.go:211-244) ---------------

    def _check_service_connectivity(
        self, pod_a: PodInfo, pod_b: PodInfo, analysis: CommunicationAnalysis
    ) -> None:
        try:
            services = self.client.get_services(pod_b.namespace)
        except ClusterError as exc:
            logger.warning(
                "failed to get services for %s: %s", pod_b.namespace, exc
            )
            return
        target: ServiceInfo | None = next(
            (
                s
                for s in services
                if s.selector and _selector_matches(s.selector, pod_b.labels)
            ),
            None,
        )
        if target is None:
            analysis.issues.append(
                f"No service found targeting Pod {pod_b.namespace}/{pod_b.name}"
            )
            analysis.solutions.append(
                f"Create a service to expose Pod {pod_b.namespace}/{pod_b.name}"
            )

    # -- check 4: CoreDNS health (ref network.go:247-267) ----------------------

    def _check_dns_connectivity(self, analysis: CommunicationAnalysis) -> None:
        try:
            pods = self.client.get_pods("kube-system")
        except ClusterError as exc:
            logger.warning("failed to get CoreDNS pods: %s", exc)
            return
        running = any(
            "coredns" in p.name and p.status == "Running" for p in pods
        )
        if not running:
            analysis.issues.append("CoreDNS is not running properly")
            analysis.solutions.append("Check CoreDNS pods in kube-system namespace")

    # -- check 5: live RTT probe (ref network.go:270-303) ----------------------

    def _check_rtt_connectivity(
        self, pod_a: str, pod_b: str, analysis: CommunicationAnalysis
    ) -> None:
        try:
            result = self.rtt_tester.test_pod_connectivity(pod_a, pod_b)
        except ClusterError as exc:
            analysis.issues.append(f"RTT test failed: {exc}")
            analysis.solutions.append(
                "Check that the pods support in-pod network command execution"
            )
            return

        if result.success_rate < 50:
            analysis.issues.append(
                f"Poor network connectivity, success rate only {result.success_rate:.1f}%"
            )
            analysis.solutions.append("Check network policies and firewall configuration")
        elif result.success_rate < 100:
            analysis.issues.append(
                f"Network packet loss detected, success rate {result.success_rate:.1f}%"
            )
            analysis.solutions.append("Check network quality and node status")

        if result.latency_assessment == "fair":
            analysis.issues.append(
                f"Moderate network latency, average RTT {result.average_rtt_ms:.2f}ms"
            )
            analysis.solutions.append(
                "Consider optimizing network configuration or checking network load"
            )
        elif result.latency_assessment in ("poor", "very_poor"):
            analysis.issues.append(
                f"High network latency, average RTT {result.average_rtt_ms:.2f}ms"
            )
            analysis.solutions.append(
                "Check network configuration and inter-node connectivity"
            )
        logger.info(
            "RTT %s -> %s: success %.1f%%, avg %.2fms, grade %s",
            pod_a,
            pod_b,
            result.success_rate,
            result.average_rtt_ms,
            result.latency_assessment,
        )

    # -- verdict (ref network.go:306-315) --------------------------------------

    def _determine_final_status(self, analysis: CommunicationAnalysis) -> None:
        if not analysis.issues:
            analysis.status = "connected"
            analysis.confidence = 0.9
            analysis.solutions.append("No obvious issues detected")
        else:
            analysis.status = "disconnected"
            analysis.confidence = 0.7
