"""Signal scraper + derived autoscaler signals (docs/observability.md).

The telemetry plane's sampling and derivation layer on top of
:class:`~k8s_llm_monitor_tpu_torch.observability.timeseries.TimeSeriesStore`:

  * ``SignalScraper`` runs one background thread that samples the local
    engine (queue tokens by SLO class, TTFT EMAs, brownout rung,
    admission headroom, KV tier occupancy, preemptions, sheds) and — on
    the router role — every replica's last ``/api/v1/stats`` probe via
    the ``ReplicaRegistry`` (``FleetRouter.telemetry_sample()``; the
    scraper never does its own HTTP, the probe loop already did).
  * A derived layer computes the ROADMAP-item-1 autoscaler contract per
    target: queue-token growth rate by class, sustained TTFT-EMA trend
    vs the per-class SLO budget, brownout dwell fraction, headroom
    slope, folded into one ``scale_hint`` (``up``/``steady``/``down``).
  * Anomaly flags (monotonic queue growth, TTFT budget breach, replica
    scrape staleness) are edge-triggered with a cooldown and injected
    into the diagnosis pipeline's event ring as synthetic Warning events
    tagged ``source="self_monitor"`` — the monitor diagnosing its own
    serving stack.

Staleness discipline (the NaN rule): a replica whose last successful
probe is older than ``stale_after_probes`` probe intervals gets NaN
markers recorded for its gauges instead of frozen values, and its
derived block carries ``stale: true``.
"""

from __future__ import annotations

import logging
import math
import threading
import time
from collections import deque
from typing import Any, Callable, Optional

from k8s_llm_monitor_tpu_torch.devtools.lockcheck import guarded_by, make_lock
from k8s_llm_monitor_tpu_torch.observability.timeseries import TimeSeriesStore
from k8s_llm_monitor_tpu_torch.resilience.slo import SLO_CLASSES

logger = logging.getLogger("observability.signals")

__all__ = ["SignalScraper"]

_NAN = float("nan")

# Local-engine series carry this target label so router-merged and
# replica-local stores share one series catalog.
LOCAL_TARGET = "local"


def _num(value: float, digits: int = 4) -> Optional[float]:
    """JSON-safe number: round finite values, map NaN/Inf to None (the
    wire marker for "not measured" — strict-JSON clients choke on NaN)."""
    try:
        v = float(value)
    except (TypeError, ValueError):
        return None
    return round(v, digits) if math.isfinite(v) else None


@guarded_by("_lock", "scrapes_total", "scrape_errors_total",
            "anomalies_total", "_probe_interval_s", "_fleet_targets",
            "evicted_targets_total")
class SignalScraper:
    """Samples load signals into a ``TimeSeriesStore`` and derives the
    autoscaler/anomaly contract from the recorded windows.

    Construction order: the scraper is built before the ``MonitorServer``
    that owns it, so the server is wired in afterwards via ``attach()``.
    ``scrape_once()`` is the synchronous seam tests and the bench drive
    directly; ``start()`` runs it on a daemon thread every
    ``cfg.scrape_interval_s``.
    """

    def __init__(self, store: Optional[TimeSeriesStore] = None,
                 cfg=None, *, pipeline: Any = None,
                 clock: Callable[[], float] = time.monotonic) -> None:
        from k8s_llm_monitor_tpu_torch.monitor.config import TelemetryConfig

        self.cfg = cfg or TelemetryConfig()
        self._clock = clock
        self.store = store or TimeSeriesStore(
            capacity=self.cfg.ring_points,
            max_series=self.cfg.max_series,
            clock=clock)
        # diagnosis.pipeline.DiagnosisPipeline (anything with
        # ``offer(EventInfo)``); None = anomalies are reported on
        # /api/v1/signals but never trigger a diagnosis.
        self.pipeline = pipeline
        self._server: Any = None
        self.scrapes_total = 0
        self.scrape_errors_total = 0
        self.anomalies_total = 0
        self.anomalies_by_flag: dict[str, int] = {}
        self._recent_anomalies: deque[dict] = deque(maxlen=32)
        self._last_emit: dict[str, float] = {}
        self._probe_interval_s: float = 0.0
        # Fleet targets seen on the previous scrape — membership GC:
        # a replica that left the registry gets its series evicted
        # instead of lingering as a permanently-stale alarm target.
        self._fleet_targets: set[str] = set()
        self.evicted_targets_total = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # Created last (lockcheck).
        self._lock = make_lock("observability.signals")

    # -- wiring ----------------------------------------------------------

    def attach(self, server: Any) -> None:
        """Wire the ``MonitorServer`` (or any object exposing
        ``engine_service()`` / ``fleet_router()``) this scraper reads."""
        self._server = server

    def role(self) -> str:
        srv = self._server
        router = srv.fleet_router() if srv is not None else None
        return "router" if router is not None else "replica"

    # -- lifecycle -------------------------------------------------------

    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()

        def _loop() -> None:
            while not self._stop.wait(timeout=self.cfg.scrape_interval_s):
                self.scrape_once()

        self._thread = threading.Thread(
            target=_loop, name="signal-scraper", daemon=True)
        self._thread.start()

    def stop(self, timeout: float = 5.0) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=timeout)
            self._thread = None

    # -- sampling --------------------------------------------------------

    def scrape_once(self) -> None:
        """One full sampling pass + anomaly evaluation.  Never raises —
        a scrape failure is a counter, not an outage."""
        srv = self._server
        if srv is None:
            return
        t = self._clock()
        try:
            svc_fn = getattr(srv, "engine_service", None)
            svc = svc_fn() if callable(svc_fn) else None
            if svc is not None:
                self._sample_engine(LOCAL_TARGET, svc, t)
            router_fn = getattr(srv, "fleet_router", None)
            router = router_fn() if callable(router_fn) else None
            if router is not None:
                sample = router.telemetry_sample()
                self._sample_fleet(sample["replicas"],
                                   sample["probe_interval_s"], t)
            with self._lock:
                self.scrapes_total += 1
        except Exception:  # noqa: BLE001 — the scrape loop must survive
            with self._lock:
                self.scrape_errors_total += 1
            logger.exception("signal scrape failed")
            return
        self._evaluate_anomalies(t)

    def _sample_engine(self, target: str, svc: Any, t: float) -> None:
        """Local-engine sample: the same signal set the fleet rows carry,
        read straight off the engine (the registry probe payload's
        source of truth)."""
        rec = self.store.record
        engine = svc.engine
        lab = {"replica": target}
        by_class = engine.queue_tokens_by_class()
        for c in SLO_CLASSES:
            rec("queue_tokens", by_class.get(c, 0),
                {"replica": target, "class": c}, t)
        rec("queue_tokens_total", engine.queue_tokens, lab, t)
        ttft = getattr(engine, "ttft_ema_by_class", {}) or {}
        for c in SLO_CLASSES:
            rec("ttft_ema_s", ttft.get(c, _NAN),
                {"replica": target, "class": c}, t)
        rec("brownout",
            engine.brownout() if engine.brownout is not None else 0, lab, t)
        headroom_fn = getattr(engine, "admission_headroom_tokens", None)
        rec("headroom_tokens",
            headroom_fn() if callable(headroom_fn) else _NAN, lab, t)
        tier_fn = getattr(engine, "kv_tier_stats", None)
        if callable(tier_fn):
            tier = tier_fn()
            has_host = getattr(engine, "host_kv_tier", None) is not None
            rec("kv_bytes", tier.get("device_bytes", _NAN),
                {"replica": target, "tier": "device"}, t)
            rec("kv_bytes",
                tier.get("host_bytes", 0) if has_host else _NAN,
                {"replica": target, "tier": "host"}, t)
            rec("kv_spills_total", tier.get("spills", 0), lab, t)
            rec("kv_restores_total", tier.get("restores", 0), lab, t)
        preempt = getattr(engine, "preemptions_by_class", {}) or {}
        sheds = getattr(svc, "shed_count_by_class", {}) or {}
        for c in SLO_CLASSES:
            rec("preemptions_total", preempt.get(c, 0),
                {"replica": target, "class": c}, t)
            rec("sheds_total", sheds.get(c, 0),
                {"replica": target, "class": c}, t)
        rec("busy_slots", engine.active_slots, lab, t)

    def _sample_fleet(self, rows: dict, probe_interval_s: float,
                      t: float) -> None:
        """Router-role sample from the registry's per-replica probe rows.
        Stale rows (probe age beyond ``stale_after_probes`` intervals, or
        never probed) record NaN markers, never frozen values."""
        interval = max(float(probe_interval_s), 1e-3)
        current = set(rows)
        with self._lock:
            self._probe_interval_s = interval
            departed = self._fleet_targets - current
            self._fleet_targets = current
        for rid in sorted(departed):
            self.evict_target(rid)
        stale_after = self.cfg.stale_after_probes * interval
        rec = self.store.record
        for rid, row in sorted(rows.items()):
            lab = {"replica": rid}
            age = row.get("probe_age_s")
            stale = age is None or float(age) > stale_after
            rec("scrape_age_s", _NAN if age is None else float(age), lab, t)
            if stale:
                for c in SLO_CLASSES:
                    rec("queue_tokens", _NAN,
                        {"replica": rid, "class": c}, t)
                    rec("ttft_ema_s", _NAN,
                        {"replica": rid, "class": c}, t)
                rec("queue_tokens_total", _NAN, lab, t)
                rec("brownout", _NAN, lab, t)
                rec("headroom_tokens", _NAN, lab, t)
                rec("busy_slots", _NAN, lab, t)
                continue
            by_class = row.get("queue_by_class") or {}
            ttft = row.get("ttft_ema_by_class") or {}
            preempt = row.get("preemptions_by_class") or {}
            sheds = row.get("shed_by_class") or {}
            for c in SLO_CLASSES:
                rec("queue_tokens", by_class.get(c, 0),
                    {"replica": rid, "class": c}, t)
                rec("ttft_ema_s", ttft.get(c, _NAN),
                    {"replica": rid, "class": c}, t)
                rec("preemptions_total", preempt.get(c, 0),
                    {"replica": rid, "class": c}, t)
                rec("sheds_total", sheds.get(c, 0),
                    {"replica": rid, "class": c}, t)
            rec("queue_tokens_total", row.get("queue_tokens", 0), lab, t)
            rec("brownout", row.get("brownout", 0), lab, t)
            headroom = row.get("headroom_tokens")
            rec("headroom_tokens",
                _NAN if headroom is None else headroom, lab, t)
            kv = row.get("kv_tier") or {}
            if kv:
                rec("kv_bytes", kv.get("device_bytes", _NAN),
                    {"replica": rid, "tier": "device"}, t)
                rec("kv_bytes", kv.get("host_bytes", _NAN),
                    {"replica": rid, "tier": "host"}, t)
                rec("kv_spills_total", kv.get("spills", 0), lab, t)
                rec("kv_restores_total", kv.get("restores", 0), lab, t)
            rec("busy_slots", row.get("busy_slots", 0), lab, t)

    def evict_target(self, target: str) -> int:
        """Membership GC for one departed fleet target: drop every
        ``{replica=target}`` series (so ``scrape_age_s`` and friends stop
        reading as stale alarms, and the cardinality cap isn't spent on
        dead replicas) and forget its anomaly cooldown keys.  Returns the
        number of series evicted.  Called automatically when a fleet
        scrape no longer lists the target; also safe to call directly
        from a registry on_remove hook."""
        if target == LOCAL_TARGET:
            return 0
        n = self.store.evict({"replica": target})
        prefix = f"{target}:"
        with self._lock:
            for key in [k for k in self._last_emit if k.startswith(prefix)]:
                del self._last_emit[key]
            if n:
                self.evicted_targets_total += 1
        if n:
            logger.info("evicted %d series for departed replica %s",
                        n, target)
        return n

    # -- derived signals -------------------------------------------------

    def _targets(self) -> list[str]:
        seen = set()
        for _, items in self.store.keys("queue_tokens_total"):
            seen.update(v for k, v in items if k == "replica")
        for _, items in self.store.keys("scrape_age_s"):
            seen.update(v for k, v in items if k == "replica")
        return sorted(seen)

    def _ttft_budget(self, slo_class: str) -> float:
        return {
            "interactive": self.cfg.ttft_budget_interactive_s,
            "standard": self.cfg.ttft_budget_standard_s,
            "batch": self.cfg.ttft_budget_batch_s,
        }.get(slo_class, self.cfg.ttft_budget_standard_s)

    def _derive(self, target: str, window_s: float,
                now: float) -> dict[str, Any]:
        """One target's autoscaler block: levels, trends, dwell, hint,
        anomaly flags.  All numbers JSON-safe (None = unmeasured)."""
        st = self.store
        cfg = self.cfg
        lab = {"replica": target}

        # Staleness: only fleet targets carry scrape_age_s; NaN there
        # means "never probed", which is as stale as it gets.
        stale = False
        if st.keys("scrape_age_s") and target != LOCAL_TARGET:
            age = st.last("scrape_age_s", lab, window_s, now=now)
            with self._lock:
                interval = self._probe_interval_s
            limit = cfg.stale_after_probes * max(interval, 1e-3)
            stale = (not math.isfinite(age)) or age > limit

        queue_last, queue_growth = {}, {}
        ttft_last, ttft_trend, ttft_breach = {}, {}, {}
        any_breach = False
        growth_up = False
        for c in SLO_CLASSES:
            cl = {"replica": target, "class": c}
            queue_last[c] = st.last("queue_tokens", cl, window_s, now=now)
            queue_growth[c] = st.rate("queue_tokens", cl, window_s, now=now)
            if (math.isfinite(queue_growth[c])
                    and queue_growth[c] > cfg.queue_growth_up_tok_s):
                growth_up = True
            ttft_last[c] = st.last("ttft_ema_s", cl, window_s, now=now)
            ttft_trend[c] = st.rate("ttft_ema_s", cl, window_s, now=now)
            # Sustained breach: over budget now AND not already falling.
            breach = (math.isfinite(ttft_last[c])
                      and ttft_last[c] > self._ttft_budget(c)
                      and not (math.isfinite(ttft_trend[c])
                               and ttft_trend[c] < 0.0))
            ttft_breach[c] = breach
            any_breach = any_breach or breach

        total_pts = [v for _, v in st.points(
            "queue_tokens_total", lab, window_s, now=now)
            if math.isfinite(v)]
        total_last = total_pts[-1] if total_pts else _NAN
        total_growth = st.rate("queue_tokens_total", lab, window_s, now=now)

        brown_pts = [v for _, v in st.points(
            "brownout", lab, window_s, now=now) if math.isfinite(v)]
        brownout_last = brown_pts[-1] if brown_pts else _NAN
        dwell = (sum(1 for v in brown_pts if v >= 1) / len(brown_pts)
                 if brown_pts else 0.0)

        headroom_last = st.last("headroom_tokens", lab, window_s, now=now)
        headroom_slope = st.rate("headroom_tokens", lab, window_s, now=now)

        # Monotonic queue growth: enough points, sustained positive rate,
        # and the newest point still at (within 5% of) the window max —
        # i.e. the backlog is climbing, not a spike already draining.
        mono_growth = (
            len(total_pts) >= 3
            and math.isfinite(total_growth)
            and total_growth > cfg.queue_growth_up_tok_s
            and total_pts[-1] >= 0.95 * max(total_pts)
            and total_pts[-1] > total_pts[0])

        if stale:
            hint = "steady"  # no fresh evidence: never scale on it
        elif (growth_up or mono_growth or any_breach
              or dwell > cfg.brownout_dwell_up):
            hint = "up"
        elif (total_pts and max(total_pts) == 0 and dwell == 0.0
              and not any_breach
              and (not math.isfinite(headroom_slope)
                   or headroom_slope >= 0.0)):
            # Idle for the whole window with headroom not shrinking.
            hint = "down"
        else:
            hint = "steady"

        flags = []
        if mono_growth:
            flags.append("queue_growth")
        if any_breach:
            flags.append("ttft_breach")
        if stale:
            flags.append("scrape_stale")

        return {
            "stale": stale,
            "scale_hint": hint,
            "anomalies": flags,
            "queue_tokens": {c: _num(queue_last[c], 1)
                             for c in SLO_CLASSES},
            "queue_growth_tok_per_s": {c: _num(queue_growth[c])
                                       for c in SLO_CLASSES},
            "queue_tokens_total": _num(total_last, 1),
            "queue_growth_total_tok_per_s": _num(total_growth),
            "ttft_ema_s": {c: _num(ttft_last[c], 6) for c in SLO_CLASSES},
            "ttft_trend_s_per_s": {c: _num(ttft_trend[c], 6)
                                   for c in SLO_CLASSES},
            "ttft_budget_breach": dict(ttft_breach),
            "brownout": _num(brownout_last, 1),
            "brownout_dwell": _num(dwell),
            "headroom_tokens": _num(headroom_last, 1),
            "headroom_slope_tok_per_s": _num(headroom_slope),
        }

    def signals(self, window_s: Optional[float] = None) -> dict[str, Any]:
        """The ``GET /api/v1/signals`` body: per-target derived blocks
        (fleet-merged on routers, just ``local`` on replicas) plus
        scraper self-accounting.  JSON-safe throughout."""
        w = float(window_s) if window_s else self.cfg.window_s
        now = self._clock()
        targets = {t: self._derive(t, w, now) for t in self._targets()}
        with self._lock:
            counters = {
                "scrapes": self.scrapes_total,
                "errors": self.scrape_errors_total,
                "anomalies": self.anomalies_total,
                "anomalies_by_flag": dict(self.anomalies_by_flag),
            }
            recent = list(self._recent_anomalies)
        counters["series"] = self.store.series_count()
        counters["interval_s"] = self.cfg.scrape_interval_s
        return {
            "role": self.role(),
            "window_s": w,
            "targets": targets,
            "recent_anomalies": recent,
            "scraper": counters,
        }

    def counters(self) -> dict:
        """Scraper self-accounting for the exporter (one lock hold)."""
        with self._lock:
            return {
                "scrapes_total": self.scrapes_total,
                "scrape_errors_total": self.scrape_errors_total,
                "anomalies_total": self.anomalies_total,
                "anomalies_by_flag": dict(self.anomalies_by_flag),
                "evicted_targets_total": self.evicted_targets_total,
            }

    # -- anomaly → diagnosis feed ---------------------------------------

    def _evaluate_anomalies(self, now: float) -> None:
        """Edge-trigger per (target, flag) with a cooldown, then inject
        synthetic Warning events into the diagnosis pipeline.  The
        pipeline call happens outside our lock — it takes its own."""
        from k8s_llm_monitor_tpu_torch.monitor.models import EventInfo

        window = self.cfg.window_s
        emit: list[tuple[str, str, dict]] = []
        for target in self._targets():
            derived = self._derive(target, window, now)
            for flag in derived["anomalies"]:
                key = f"{target}:{flag}"
                with self._lock:
                    last = self._last_emit.get(key)
                    if (last is not None
                            and now - last < self.cfg.anomaly_cooldown_s):
                        continue
                    self._last_emit[key] = now
                    self.anomalies_total += 1
                    self.anomalies_by_flag[flag] = (
                        self.anomalies_by_flag.get(flag, 0) + 1)
                    self._recent_anomalies.append({
                        "t_mono": round(now, 3),
                        "target": target,
                        "flag": flag,
                        "scale_hint": derived["scale_hint"],
                    })
                emit.append((target, flag, derived))
        if not emit or self.pipeline is None or not self.cfg.feed_diagnosis:
            return
        for target, flag, derived in emit:
            detail = {
                "queue_growth": (
                    f"queue tokens growing at "
                    f"{derived['queue_growth_total_tok_per_s']} tok/s "
                    f"(total {derived['queue_tokens_total']})"),
                "ttft_breach": (
                    f"TTFT EMA over SLO budget, not falling: "
                    f"{derived['ttft_ema_s']}"),
                "scrape_stale": (
                    "stats probe stale beyond "
                    f"{self.cfg.stale_after_probes}x probe interval"),
            }.get(flag, flag)
            event = EventInfo(
                type="Warning",
                reason=f"SelfMonitor:{flag}",
                message=f"replica {target}: {detail}",
                source="self_monitor",
            )
            try:
                self.pipeline.offer(event)
            except Exception:  # noqa: BLE001 — feed is best-effort
                logger.exception("self_monitor event injection failed")
