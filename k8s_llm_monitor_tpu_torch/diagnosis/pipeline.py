"""Standing watcher→LLM root-cause pipeline.

Closes the loop the reference left open: cluster events stream in through
the ``Watcher``'s ``EventHandler`` seam, a burst detector decides when the
cluster is "interesting enough" to spend a generation on, a context
assembler packs a bounded evidence block (embedding top-k retrieval when an
encoder is configured, recency otherwise), and one grammar-constrained
root-cause query per burst lands in a verdict ring published as exporter
gauges and ``GET /api/v1/diagnoses``.

Threading model: ``DiagnosisEventHandler`` methods run on watcher threads
and must stay cheap — they append to rings and enqueue triggers.  The
single worker thread owns all LLM calls, so a slow generation can never
back up the watch streams; bursts arriving mid-generation coalesce into
the next query instead of queueing one generation each.
"""

from __future__ import annotations

import logging
import queue
import threading
import time
from collections import deque
from typing import Any, Callable

import numpy as np

from k8s_llm_monitor_tpu_torch.devtools.lockcheck import guarded_by, make_lock
from k8s_llm_monitor_tpu_torch.monitor.models import EventInfo, utcnow
from k8s_llm_monitor_tpu_torch.monitor.watcher import EventHandler
from k8s_llm_monitor_tpu_torch.observability.tracing import get_tracer

logger = logging.getLogger("diagnosis.pipeline")


class BurstDetector:
    """Sliding-window burst detection with a refractory cooldown.

    ``observe()`` returns True when the number of observations inside the
    trailing ``window_s`` reaches ``threshold`` AND at least ``cooldown_s``
    has passed since the last firing — one incident produces one trigger,
    not one per event above the threshold.  The clock is injectable so
    tests drive it deterministically.
    """

    def __init__(self, threshold: int = 5, window_s: float = 60.0,
                 cooldown_s: float = 120.0,
                 clock: Callable[[], float] = time.monotonic) -> None:
        if threshold < 1:
            raise ValueError("threshold must be >= 1")
        self.threshold = threshold
        self.window_s = window_s
        self.cooldown_s = cooldown_s
        self._clock = clock
        self._times: deque[float] = deque()
        self._last_fire: float | None = None

    def observe(self) -> bool:
        now = self._clock()
        self._times.append(now)
        while self._times and now - self._times[0] > self.window_s:
            self._times.popleft()
        if len(self._times) < self.threshold:
            return False
        if (self._last_fire is not None
                and now - self._last_fire < self.cooldown_s):
            return False
        self._last_fire = now
        # Consume the window: the NEXT burst needs threshold fresh events,
        # so a long cooldown doesn't fire instantly off stale ones.
        self._times.clear()
        return True

    def pending(self) -> int:
        """Observations currently inside the window (diagnostics)."""
        now = self._clock()
        while self._times and now - self._times[0] > self.window_s:
            self._times.popleft()
        return len(self._times)


@guarded_by("_lock", "_texts")
class ContextAssembler:
    """Bounded cluster-context block from the recent event stream.

    Keeps the last ``capacity`` event texts; ``assemble(query)`` selects
    ``top_k`` of them — by embedding cosine similarity to the query when an
    encoder is available (``analysis.anomaly.EmbeddingAnomalyDetector`` or
    anything with ``embed(texts) -> [N, H]`` L2-normalized), else the most
    recent — renders them chronologically, and hard-caps the block at
    ``max_chars`` so prompt size stays bounded no matter how noisy the
    cluster gets.
    """

    def __init__(self, capacity: int = 64, top_k: int = 8,
                 max_chars: int = 2000, embedder: Any = None) -> None:
        self.capacity = capacity
        self.top_k = top_k
        self.max_chars = max_chars
        self.embedder = embedder
        self._texts: deque[str] = deque(maxlen=capacity)
        self._lock = make_lock("diagnosis.context")

    def add(self, text: str) -> None:
        with self._lock:
            self._texts.append(text)

    def __len__(self) -> int:
        with self._lock:
            return len(self._texts)

    def _select(self, texts: list[str], query: str) -> list[str]:
        if len(texts) <= self.top_k:
            return texts
        if self.embedder is not None:
            try:
                vecs = self.embedder.embed(list(texts) + [query])
                sims = vecs[:-1] @ vecs[-1]
                keep = sorted(np.argsort(-sims)[: self.top_k])
                return [texts[i] for i in keep]
            except Exception as exc:  # noqa: BLE001 — retrieval is best-effort
                logger.warning("embedding retrieval failed (%s); "
                               "falling back to recency", exc)
        return texts[-self.top_k:]

    def assemble(self, query: str = "") -> str:
        with self._lock:
            texts = list(self._texts)
        if not texts:
            return "## Recent cluster events\n- none observed\n"
        lines = ["## Recent cluster events"]
        budget = self.max_chars - len(lines[0]) - 1
        for text in self._select(texts, query):
            line = f"- {text}"
            if budget - len(line) - 1 < 0:
                break
            lines.append(line)
            budget -= len(line) + 1
        return "\n".join(lines) + "\n"


@guarded_by("_lock", "_history", "_counts", "_lag_ms")
class VerdictStore:
    """Ring-buffer verdict history + the counters behind the exporter's
    ``diagnosis_*`` gauges.  All access is lock-guarded: the pipeline
    worker publishes while HTTP handler threads snapshot."""

    SEVERITIES = ("info", "warning", "critical")

    def __init__(self, capacity: int = 64) -> None:
        self.capacity = capacity
        self._history: deque[dict[str, Any]] = deque(maxlen=capacity)
        self._counts: dict[str, int] = {s: 0 for s in self.SEVERITIES}
        self._lag_ms: float = 0.0
        self._lock = make_lock("diagnosis.verdicts")

    def publish(self, verdict: dict[str, Any], *, trigger: str = "",
                lag_ms: float = 0.0, model: str = "") -> dict[str, Any]:
        entry = {
            "verdict": dict(verdict),
            "trigger": trigger,
            "model": model,
            "lag_ms": round(lag_ms, 3),
            "timestamp": utcnow().isoformat(),
        }
        sev = verdict.get("severity", "")
        with self._lock:
            self._history.append(entry)
            if sev in self._counts:
                self._counts[sev] += 1
            self._lag_ms = lag_ms
        return entry

    def snapshot(self, limit: int = 0) -> list[dict[str, Any]]:
        """Newest-first history (the shape ``GET /api/v1/diagnoses``
        returns)."""
        with self._lock:
            items = list(self._history)
        items.reverse()
        return items[:limit] if limit > 0 else items

    def counts(self) -> dict[str, int]:
        with self._lock:
            return dict(self._counts)

    def lag_ms(self) -> float:
        with self._lock:
            return self._lag_ms

    def __len__(self) -> int:
        with self._lock:
            return len(self._history)


class DiagnosisEventHandler(EventHandler):
    """The ``Watcher``-facing adapter: every event feeds the context ring;
    Warning events additionally feed the burst detector."""

    def __init__(self, pipeline: "DiagnosisPipeline") -> None:
        self.pipeline = pipeline

    @staticmethod
    def format_event(event: EventInfo) -> str:
        text = f"{event.reason}: {event.message}"
        if event.source:
            text += f" (source {event.source})"
        if event.count > 1:
            text += f" x{event.count}"
        return text

    def on_event(self, event: EventInfo) -> None:
        self.pipeline.offer(event)

    def on_pod_update(self, event_type: str, pod) -> None:  # noqa: D102
        # Pod phase churn lands in the context ring (it is exactly what a
        # root-cause prompt needs alongside the warning events) but does
        # not count toward bursts — event objects carry the signal.
        if event_type in ("MODIFIED", "DELETED"):
            phase = getattr(pod, "phase", "")
            if phase and phase != "Running":
                self.pipeline.context.add(
                    f"pod {getattr(pod, 'namespace', '?')}/"
                    f"{getattr(pod, 'name', '?')} phase={phase}")


class DiagnosisPipeline:
    """Watcher events → bursts → one constrained root-cause query each.

    ``analysis`` is an ``AnalysisEngine`` (anything with
    ``diagnose(question, context=...) -> dict``).  Triggers that arrive
    while a generation is running coalesce: the worker drains the queue
    and answers them with a single query over the merged reasons.
    """

    def __init__(self, analysis, cfg=None, *, embedder: Any = None,
                 brownout: Callable[[], int] | None = None,
                 clock: Callable[[], float] = time.monotonic) -> None:
        from k8s_llm_monitor_tpu_torch.monitor.config import DiagnosisConfig

        self.analysis = analysis
        self.cfg = cfg or DiagnosisConfig()
        self._clock = clock
        # Brownout rung supplier (resilience/slo.py): at draining (>= 2)
        # trigger enqueue pauses — the engine is shedding real traffic, so
        # background diagnosis must not compete for its slots.
        self._brownout = brownout
        self.paused_total = 0
        self.detector = BurstDetector(
            threshold=self.cfg.burst_threshold,
            window_s=self.cfg.window_s,
            cooldown_s=self.cfg.cooldown_s,
            clock=clock,
        )
        self.context = ContextAssembler(
            capacity=self.cfg.max_context_events,
            top_k=self.cfg.context_top_k,
            max_chars=self.cfg.max_context_chars,
            embedder=embedder,
        )
        self.store = VerdictStore(capacity=self.cfg.history)
        self.handler = DiagnosisEventHandler(self)
        # Plan stage (remediation/executor.py RemediationEngine), wired by
        # build_server behind RemediationConfig; None leaves the pipeline
        # verdict-only.
        self.remediation: Any = None
        self.triggers_total = 0
        self.queries_total = 0
        self.errors_total = 0
        self._queue: queue.Queue = queue.Queue()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    # -- watcher-thread side --------------------------------------------------

    def offer(self, event: EventInfo) -> None:
        """Feed one cluster event; cheap enough for watcher threads."""
        self.context.add(DiagnosisEventHandler.format_event(event))
        if event.type != "Warning":
            return
        if self.detector.observe():
            if self._brownout is not None:
                try:
                    paused = int(self._brownout()) >= 2
                except Exception:  # noqa: BLE001 — never drop the watcher
                    paused = False
                if paused:
                    self.paused_total += 1
                    return
            self.triggers_total += 1
            self._queue.put({
                "reason": event.reason or "warning burst",
                "t": self._clock(),
            })

    # -- worker side ----------------------------------------------------------

    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, name="diagnosis-pipeline", daemon=True)
        self._thread.start()

    def stop(self, timeout: float = 10.0) -> None:
        self._stop.set()
        self._queue.put(None)
        if self._thread is not None:
            self._thread.join(timeout=timeout)
            self._thread = None

    def _run(self) -> None:
        while not self._stop.is_set():
            trigger = self._queue.get()
            if trigger is None or self._stop.is_set():
                return
            # Coalesce everything already queued into this one query.
            reasons = [trigger["reason"]]
            t0 = trigger["t"]
            while True:
                try:
                    extra = self._queue.get_nowait()
                except queue.Empty:
                    break
                if extra is None:
                    return
                reasons.append(extra["reason"])
            try:
                self._diagnose_once(reasons, t0)
            except Exception:  # noqa: BLE001 — the loop must survive
                self.errors_total += 1
                logger.exception("diagnosis query failed")

    def _diagnose_once(self, reasons: list[str], t_trigger: float) -> None:
        uniq = sorted(set(reasons))
        tracer = get_tracer()
        lag_s = max(0.0, self._clock() - t_trigger)
        with tracer.span("diagnosis.run", root=True,
                         attrs={"reasons": ", ".join(uniq)[:200],
                                "n_triggers": len(reasons)}) as run_sp:
            # Trigger span: queue-wait between burst detection (watcher
            # thread) and this worker picking it up.  The pipeline clock is
            # injectable, so the span is rebuilt on the real monotonic axis
            # from the measured lag rather than trusting t_trigger directly.
            t_run = time.monotonic()
            tracer.record("diagnosis.trigger", t_run - lag_s, t_run,
                          tracer.current(),
                          attrs={"reasons": ", ".join(uniq)[:200]})
            question = (
                "A burst of Warning events was just observed "
                f"(reasons: {', '.join(uniq)}). Identify the most probable "
                "root cause and the first remediation step."
            )
            with tracer.span("diagnosis.context") as ctx_sp:
                context = self.context.assemble(question)
                ctx_sp.attrs["context_chars"] = len(context)
            # Background root-cause work rides the lowest lane: interactive
            # operators must never queue behind an automatic trigger.
            with tracer.span("diagnosis.llm", attrs={"class": "batch"}):
                verdict = self.analysis.diagnose(question, context=context,
                                                 slo_class="batch")
            self.queries_total += 1
            lag_ms = max(0.0, (self._clock() - t_trigger) * 1000.0)
            run_sp.attrs["trigger_lag_ms"] = round(lag_ms, 1)
            run_sp.attrs["severity"] = str(verdict.get("severity", ""))
        self.store.publish(
            verdict, trigger=", ".join(uniq), lag_ms=lag_ms,
            model=getattr(getattr(self.analysis, "backend", None),
                          "name", ""))
        logger.info("diagnosis published: severity=%s component=%s "
                    "lag=%.0fms", verdict.get("severity"),
                    verdict.get("component"), lag_ms)
        # Plan stage: verdict → grammar-bounded action plan (and, when
        # configured, gated execution + verification).  After publish —
        # a failing plan stage must never cost the verdict, and
        # on_verdict itself never raises.
        if self.remediation is not None:
            self.remediation.on_verdict(
                verdict, trigger=", ".join(uniq), context=context)

    def run_pending(self) -> int:
        """Drain queued triggers synchronously (tests / no-thread mode).
        Returns the number of queries executed."""
        ran = 0
        batches: list[tuple[list[str], float]] = []
        reasons: list[str] = []
        t0 = None
        while True:
            try:
                trig = self._queue.get_nowait()
            except queue.Empty:
                break
            if trig is None:
                continue
            reasons.append(trig["reason"])
            t0 = trig["t"] if t0 is None else t0
        if reasons and t0 is not None:
            batches.append((reasons, t0))
        for rs, t in batches:
            try:
                self._diagnose_once(rs, t)
                ran += 1
            except Exception:  # noqa: BLE001
                self.errors_total += 1
                logger.exception("diagnosis query failed")
        return ran
