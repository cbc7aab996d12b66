"""UAV-aware scheduling controller over the CRD bus.

Parity target: ``/root/reference/internal/scheduler/controller.go`` —
poll-based reconcile (not informer-based) listing ``scheduler.io/v1
schedulingrequests`` and ``monitoring.io/v1 uavmetrics`` cluster-wide each
tick (:88-110), processing only empty/Pending requests (:112-120), manual
spec decoding + workload validation (:121-150), candidate building with
the battery filter + ``collection_status == "active"`` gate and the
battery + preferred-node-bonus scoring (:174-221), and status writes
through the ``/status`` subresource (:223-250).

Extension over the reference: candidates on nodes with TPU chips get a
configurable bonus so accelerator workloads land next to the inference
plane (the reference accepts but ignores such annotations — see
examples/multi-pod-request.yaml's comment).
"""

from __future__ import annotations

import logging
import threading
from dataclasses import dataclass
from typing import Any

from k8s_llm_monitor_tpu_torch.monitor.client import (
    SCHEDULING_GVR,
    UAV_METRICS_GVR,
    Client,
)
from k8s_llm_monitor_tpu_torch.monitor.cluster import ClusterError
from k8s_llm_monitor_tpu_torch.monitor.models import (
    SchedulingCandidate,
    parse_rfc3339,
    rfc3339,
    utcnow,
)

logger = logging.getLogger("monitor.scheduler")

PREFERRED_NODE_BONUS = 10.0  # ref controller.go:205-208


@dataclass
class SchedulerConfig:
    interval: float = 15.0  # ref cmd/scheduler/main.go:24 default
    tpu_node_bonus: float = 5.0  # extension: prefer TPU-carrying nodes
    # Staleness gate (fixes the reference's soft spot, controller.go:202-203:
    # heartbeat parsed but never used — a dead UAV with a fresh-looking CR
    # could win placement).  A candidate is excluded when its last_update is
    # older than ``stale_heartbeat_factor`` x its advertised heartbeat
    # interval, or older than ``stale_after_seconds`` when no interval is
    # advertised.  <= 0 disables either gate.
    stale_heartbeat_factor: float = 3.0
    stale_after_seconds: float = 120.0


class SchedulerController:
    def __init__(self, client: Client, cfg: SchedulerConfig | None = None) -> None:
        self.client = client
        self.cfg = cfg or SchedulerConfig()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self.reconcile_count = 0
        self.assigned_count = 0
        self.failed_count = 0

    # -- lifecycle -------------------------------------------------------------

    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, name="scheduler", daemon=True
        )
        self._thread.start()

    def stop(self, timeout: float = 5.0) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=timeout)
            if not self._thread.is_alive():
                self._thread = None

    def _loop(self) -> None:
        while True:
            try:
                self.reconcile()
            except Exception as exc:  # noqa: BLE001 — keep reconciling
                logger.exception("reconcile failed: %s", exc)
            if self._stop.wait(self.cfg.interval):
                return

    # -- reconcile (ref controller.go:88-110) ------------------------------------

    def reconcile(self) -> int:
        """One pass; returns the number of requests processed."""
        backend = self.client.backend
        sg, sv, sp = SCHEDULING_GVR
        ug, uv, up = UAV_METRICS_GVR
        try:
            requests = backend.list_custom_resources(sg, sv, sp, None)
            uav_metrics = backend.list_custom_resources(ug, uv, up, None)
        except ClusterError as exc:
            logger.warning("reconcile list failed: %s", exc)
            return 0
        self.reconcile_count += 1
        processed = 0
        for req in requests:
            phase = (req.get("status") or {}).get("phase", "")
            if phase not in ("", "Pending"):
                continue  # only fresh requests (ref :117-120)
            self._process_request(req, uav_metrics)
            processed += 1
        return processed

    # -- per-request (ref controller.go:112-172) ----------------------------------

    def _process_request(self, req: dict[str, Any], uav_metrics: list[dict]) -> None:
        md = req.get("metadata", {})
        name = md.get("name", "")
        namespace = md.get("namespace", "")
        spec = req.get("spec", {}) or {}
        workload = spec.get("workload", {}) or {}

        if not workload.get("name") or not workload.get("namespace"):
            self._update_status(
                req,
                phase="Failed",
                message="workload name and namespace are required",
            )
            self.failed_count += 1
            return

        # Reference semantics (controller.go:174-221): no battery filter at
        # all when minBatteryPercent is absent or 0 — no silent default floor.
        min_battery = float(spec.get("minBatteryPercent") or 0.0)
        preferred = {str(n).lower() for n in (spec.get("preferredNodes") or [])}
        candidates = self._build_candidates(uav_metrics, min_battery, preferred)

        if not candidates:
            self._update_status(
                req,
                phase="Failed",
                message=f"no active UAV with battery >= {min_battery:.0f}%",
            )
            self.failed_count += 1
            logger.info("request %s/%s failed: no candidates", namespace, name)
            return

        best = max(candidates, key=lambda c: c.score)
        self._update_status(
            req,
            phase="Assigned",
            node=best.node_name,
            uav=best.uav_id,
            score=best.score,
            message=(
                f"assigned to {best.node_name} "
                f"(uav {best.uav_id}, battery {best.battery:.0f}%)"
            ),
        )
        self.assigned_count += 1
        logger.info(
            "request %s/%s assigned to %s (score %.1f)",
            namespace,
            name,
            best.node_name,
            best.score,
        )

    # -- candidates (ref controller.go:174-221) ------------------------------------

    def _build_candidates(
        self,
        uav_metrics: list[dict],
        min_battery: float,
        preferred: set[str],
    ) -> list[SchedulingCandidate]:
        tpu_nodes = self._tpu_nodes()
        out: list[SchedulingCandidate] = []
        for cr in uav_metrics:
            spec = cr.get("spec", {}) or {}
            status = cr.get("status", {}) or {}
            node = spec.get("node_name", "")
            battery = float(
                ((spec.get("battery") or {}).get("remaining_percent")) or 0.0
            )
            if not node:
                continue
            # Ref :198-200: only explicit non-"active" values disqualify —
            # an empty/missing collection_status is accepted; the comparison
            # is case-insensitive.
            cstatus = str(status.get("collection_status") or "")
            if cstatus and cstatus.lower() != "active":
                continue
            if min_battery > 0 and battery < min_battery:
                continue
            last = parse_rfc3339(status.get("last_update"))
            if last is not None and self._is_stale(
                last, float(status.get("heartbeat_interval_seconds") or 0.0)
            ):
                continue
            score = battery
            if node.lower() in preferred:
                score += PREFERRED_NODE_BONUS
            if node in tpu_nodes:
                score += self.cfg.tpu_node_bonus
            out.append(
                SchedulingCandidate(
                    node_name=node,
                    uav_id=spec.get("uav_id", ""),
                    battery=battery,
                    last_heartbeat=parse_rfc3339(status.get("last_update")),
                    score=score,
                )
            )
        return out

    def _is_stale(self, last_update, heartbeat_s: float) -> bool:
        """True when a CR's last_update is too old to trust its status."""
        age = (utcnow() - last_update).total_seconds()
        if heartbeat_s > 0 and self.cfg.stale_heartbeat_factor > 0:
            return age > self.cfg.stale_heartbeat_factor * heartbeat_s
        if self.cfg.stale_after_seconds > 0:
            return age > self.cfg.stale_after_seconds
        return False

    def _tpu_nodes(self) -> set[str]:
        try:
            return {
                n["metadata"]["name"]
                for n in self.client.backend.list_nodes()
                if int(
                    (n.get("status", {}).get("capacity", {}) or {}).get(
                        "google.com/tpu", 0
                    )
                    or 0
                )
                > 0
            }
        except ClusterError:
            return set()

    # -- status write (ref controller.go:223-250) -----------------------------------

    def _update_status(
        self,
        req: dict[str, Any],
        phase: str,
        node: str = "",
        uav: str = "",
        score: float = 0.0,
        message: str = "",
    ) -> None:
        sg, sv, sp = SCHEDULING_GVR
        status: dict[str, Any] = {
            "phase": phase,
            "lastUpdated": rfc3339(utcnow()),
        }
        if node:
            status["assignedNode"] = node
        if uav:
            status["assignedUAV"] = uav
        if score:
            status["score"] = score
        if message:
            status["message"] = message
        body = {
            "metadata": {
                "name": req["metadata"]["name"],
                "namespace": req["metadata"].get("namespace", ""),
            },
            "status": status,
        }
        try:
            self.client.backend.update_custom_resource_status(
                sg, sv, sp, req["metadata"].get("namespace") or None, body
            )
        except ClusterError as exc:
            logger.warning(
                "status update for %s failed: %s", req["metadata"].get("name"), exc
            )
