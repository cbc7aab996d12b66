"""Prometheus text-format self-observability exporter.

The JAX package's ``monitor/exporter.py`` for the port: it renders the
monitor's own health as Prometheus exposition text (version 0.0.4, or
OpenMetrics when asked) for the ``GET /metrics`` route:

  * serving engine gauges/counters: queue depth, active slots, free KV
    blocks, prefill/decode-step/preemption totals, TTFT histogram;
  * metrics-manager collection stats and snapshot sizes;
  * accelerator gauges (device count, device kind, bytes in use and the
    card's memory) from ``torch.cuda``.

Every family keeps the JAX exporter's name, type and labels; only
``_device_metrics`` reads another runtime.  No client library.
"""

from __future__ import annotations

import math
import re
from typing import TYPE_CHECKING

if TYPE_CHECKING:  # pragma: no cover
    from k8s_llm_monitor_tpu_torch.monitor.server import MonitorServer

_PREFIX = "k8s_llm_monitor"

_METRIC_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABELS_RE = re.compile(
    r'^\{[a-zA-Z_][a-zA-Z0-9_]*="[^"]*"'
    r'(,[a-zA-Z_][a-zA-Z0-9_]*="[^"]*")*\}$')
_SAMPLE_RE = re.compile(
    r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{[^}]*\})?\s+(\S+)$")


class _Writer:
    def __init__(self, openmetrics: bool = False) -> None:
        self.lines: list[str] = []
        self.openmetrics = openmetrics

    def metric(self, name: str, mtype: str, help_: str,
               samples: list[tuple[str, float]]) -> None:
        """samples: [(labels_suffix_or_empty, value)]"""
        full = f"{_PREFIX}_{name}"
        self.lines.append(f"# HELP {full} {help_}")
        self.lines.append(f"# TYPE {full} {mtype}")
        for labels, value in samples:
            if isinstance(value, float) and math.isinf(value):
                value = "+Inf" if value > 0 else "-Inf"
            elif isinstance(value, float) and math.isnan(value):
                value = "NaN"
            self.lines.append(f"{full}{labels} {value}")

    def histogram(self, name: str, help_: str, hist) -> None:
        """Render an ``observability.metrics.ClassHistogram`` as one
        Prometheus histogram family with a ``class`` label per SLO class.
        In OpenMetrics mode each bucket with an exemplar gets the
        ``# {trace_id="..."} value ts`` annotation — the dashboard's jump
        from a bad latency bucket to the trace that landed in it."""
        full = f"{_PREFIX}_{name}"
        self.lines.append(f"# HELP {full} {help_}")
        self.lines.append(f"# TYPE {full} histogram")
        for cls in hist.classes():
            cum, total, count, exemplars = hist.series(cls)
            edges = [str(b) for b in hist.buckets] + ["+Inf"]
            for i, (le, c) in enumerate(zip(edges, cum)):
                line = f'{full}_bucket{{class="{cls}",le="{le}"}} {c}'
                ex = exemplars.get(i) if self.openmetrics else None
                if ex is not None:
                    tid, value, ts = ex
                    line += (f' # {{trace_id="{tid}"}} '
                             f"{round(value, 6)} {round(ts, 3)}")
                self.lines.append(line)
            self.lines.append(
                f'{full}_sum{{class="{cls}"}} {round(total, 6)}')
            self.lines.append(f'{full}_count{{class="{cls}"}} {count}')

    def render(self) -> str:
        body = "\n".join(self.lines) + "\n"
        if self.openmetrics:
            body += "# EOF\n"
        return body


def lint_exposition(text: str) -> list[str]:
    """Validate Prometheus/OpenMetrics text exposition: every sample
    belongs to a family with exactly one HELP and one TYPE, names and
    label blocks are well-formed, values parse, and special markers use
    the canonical spellings (``NaN``, ``+Inf``).  Returns human-readable
    error strings; empty means clean.  Runs at render time (the exporter
    appends its own error count as a metric) and in the tier-1 lint test.
    """
    errors: list[str] = []
    helps: dict[str, int] = {}
    types: dict[str, str] = {}
    for n, raw in enumerate(text.splitlines(), start=1):
        line = raw.rstrip()
        if not line or line == "# EOF":
            continue
        if line.startswith("# HELP ") or line.startswith("# TYPE "):
            kind = line[2:6]
            parts = line.split(" ", 3)
            if len(parts) < 4 or not parts[3].strip():
                errors.append(f"line {n}: bare {kind} with no text")
                continue
            fam = parts[2]
            if not _METRIC_NAME_RE.match(fam):
                errors.append(f"line {n}: invalid family name {fam!r}")
            if kind == "HELP":
                helps[fam] = helps.get(fam, 0) + 1
                if helps[fam] > 1:
                    errors.append(f"line {n}: duplicate HELP for {fam}")
            else:
                if fam in types:
                    errors.append(f"line {n}: duplicate TYPE for {fam}")
                types[fam] = parts[3].strip()
            continue
        if line.startswith("#"):
            continue  # free-form comment
        # Sample line; OpenMetrics exemplars hang off " # ".
        sample, _, exemplar = line.partition(" # ")
        m = _SAMPLE_RE.match(sample.strip())
        if m is None:
            errors.append(f"line {n}: unparseable sample {line!r}")
            continue
        name, labels, value = m.groups()
        fam = name
        for suffix in ("_bucket", "_sum", "_count"):
            if (name.endswith(suffix) and name[: -len(suffix)] in types
                    and types[name[: -len(suffix)]] == "histogram"):
                fam = name[: -len(suffix)]
                break
        if fam not in types:
            errors.append(f"line {n}: sample {name} has no TYPE")
        if fam not in helps:
            errors.append(f"line {n}: sample {name} has no HELP")
        if labels and not _LABELS_RE.match(labels):
            errors.append(f"line {n}: malformed labels {labels!r}")
        if value in ("nan", "inf", "-inf", "+inf", "Inf"):
            errors.append(
                f"line {n}: non-canonical marker {value!r} "
                "(use NaN/+Inf/-Inf)")
        else:
            try:
                float(value)
            except ValueError:
                errors.append(f"line {n}: bad value {value!r}")
        if exemplar:
            ex = exemplar.strip()
            if not ex.startswith("{") or "}" not in ex:
                errors.append(f"line {n}: malformed exemplar {ex!r}")
    for fam in types:
        if fam not in helps:
            errors.append(f"family {fam}: TYPE without HELP")
    for fam in helps:
        if fam not in types:
            errors.append(f"family {fam}: HELP without TYPE")
    return errors


def _engine_metrics(w: _Writer, engine) -> None:
    w.metric("engine_queue_depth", "gauge",
             "Requests waiting for admission",
             [("", engine.queue_depth)])
    w.metric("engine_active_slots", "gauge",
             "Decode lanes currently occupied",
             [("", engine.active_slots)])
    w.metric("engine_slots_total", "gauge",
             "Configured decode lanes",
             [("", engine.ecfg.max_slots)])
    w.metric("engine_free_kv_blocks", "gauge",
             "KV cache blocks available in the pool",
             [("", engine.allocator.free_blocks)])
    w.metric("engine_kv_blocks_total", "gauge",
             "Configured KV cache blocks",
             [("", engine.ecfg.num_blocks)])
    w.metric("engine_prefills_total", "counter",
             "Prompts ingested via prefill",
             [("", engine.prefills)])
    w.metric("engine_decode_steps_total", "counter",
             "Device decode steps executed",
             [("", engine.steps)])
    w.metric("engine_preemptions_total", "counter",
             "Recompute-preemptions under KV pressure",
             [("", engine.preemptions)])
    if engine.prefix_cache is not None:
        w.metric("engine_prefix_cache_hits_total", "counter",
                 "Admissions served a cached prompt prefix",
                 [("", engine.prefix_cache.hits)])
        w.metric("engine_prefix_cache_misses_total", "counter",
                 "Admissions that found no cached prefix",
                 [("", engine.prefix_cache.misses)])
        w.metric("engine_prefix_deferrals_total", "counter",
                 "Requests whose admission waited for a publishing "
                 "same-prefix lane (cold-burst dedup)",
                 [("", engine.prefix_deferrals)])
    # KV tiering (serving/kv_tier.py): per-tier byte accounting plus the
    # spill/restore flow between them.  The host sample is an explicit
    # NaN when no spill buffer is configured — an absent-vs-zero mixup
    # across a fleet scrape would hide "this replica cannot spill".
    tier_fn = getattr(engine, "kv_tier_stats", None)
    if callable(tier_fn):
        t = tier_fn()
        has_host = getattr(engine, "host_kv_tier", None) is not None
        w.metric("kv_tier_bytes", "gauge",
                 "KV bytes held per tier (device = configured resident "
                 "pool incl. quantization scales; host = spilled prefix "
                 "entries; NaN host = no spill buffer configured)",
                 [('{tier="device"}', t["device_bytes"]),
                  ('{tier="host"}', t["host_bytes"] if has_host
                   else float("nan"))])
        quant = t["kv_quant"] or "none"
        w.metric("kv_quant_info", "gauge",
                 "Resident KV quantization mode and page dtype "
                 "(1 = active)",
                 [(f'{{mode="{quant}",dtype="{t["page_dtype"]}"}}', 1)])
        w.metric("kv_spills_total", "counter",
                 "Cold prefix entries evicted to the host tier instead of "
                 "dropped", [("", t["spills"])])
        w.metric("kv_restores_total", "counter",
                 "Host-tier prefix entries rehydrated into device pages "
                 "on a hit", [("", t["restores"])])
        w.metric("kv_host_lost_total", "counter",
                 "Host-tier entries dropped under host-buffer pressure "
                 "(next hit falls back to prompt replay)",
                 [("", t["host_lost"])])
    # Tier-aware admission headroom (engine.admission_headroom_tokens):
    # the token capacity should_shed()'s kv_admission clause admits
    # against — free device blocks plus, under the "tier" policy, the
    # spillable prefix-cache span the host tier has room for.
    headroom_fn = getattr(engine, "admission_headroom_tokens", None)
    if callable(headroom_fn):
        w.metric("kv_admission_headroom_tokens", "gauge",
                 "KV tokens the admission capacity clause can still "
                 "place (device free + host-spillable under "
                 "kv_admission=tier)",
                 [("", headroom_fn())])
    w.metric("engine_chunk_shrinks_total", "counter",
             "Chunked-prefill rounds shrunk below the configured bucket "
             "because interactive-class work was queued",
             [("", getattr(engine, "chunk_shrinks", 0))])
    w.metric("engine_chunk_bucket", "gauge",
             "Prefill bucket used by the most recent chunked round "
             "(0 until a chunked prefill has run)",
             [("", getattr(engine, "last_chunk_bucket", 0))])
    w.metric("engine_spec_tokens_total", "counter",
             "Tokens emitted by speculative-decode dispatches",
             [("", engine.spec_tokens)])
    w.metric("engine_spec_verify_steps_total", "counter",
             "Verify forwards run by speculative-decode dispatches",
             [("", engine.spec_verify_steps)])
    w.metric("engine_spec_lane_rounds_total", "counter",
             "Active lane-rounds across spec verify forwards (divide "
             "spec_tokens by this for per-lane acceptance)",
             [("", engine.spec_lane_rounds)])
    # Per-request-class accepted-length EMA (serving/spec.py:AcceptanceEMA):
    # the signal behind the adaptive drafting kill-switch.  Absent until a
    # class has a measurement — a missing class label means "never probed",
    # not zero acceptance.
    ema_fn = getattr(engine, "spec_accept_ema", None)
    snap = ema_fn() if callable(ema_fn) else {}
    if snap:
        w.metric("spec_accept_ema", "gauge",
                 "Accepted tokens per lane-round EMA, by request class; "
                 "drafting auto-disables below the configured floor",
                 [(f'{{class="{k}"}}', round(v, 4))
                  for k, v in sorted(snap.items())])

    # Mesh topology: one sample per axis of the serving mesh, so the
    # dashboard can tell a TP-8 v5e slice from a single chip without
    # scraping the deployment spec.  Off-mesh engines emit nothing.
    mesh_fn = getattr(engine, "mesh_axes", None)
    axes = mesh_fn() if callable(mesh_fn) else {}
    if axes:
        w.metric("mesh_axes", "gauge",
                 "Serving mesh axis sizes (data/seq/model)",
                 [(f'{{axis="{a}"}}', int(n))
                  for a, n in sorted(axes.items())])
        w.metric("engine_decode_collective_share", "gauge",
                 "Estimated ICI (collective) share of a TP decode step, "
                 "from the decode profile's byte model; 0 until "
                 "profile_decode_phases() has run",
                 [("", round(getattr(engine, "decode_collective_share",
                                     0.0), 4))])
        w.metric("engine_tp_overlap", "gauge",
                 "1 when the hand-staged reduce-scatter/all-gather decode "
                 "schedule is active (parallel/overlap.py); 0 = GSPMD "
                 "reference program",
                 [("", 1 if getattr(engine, "tp_overlap", False) else 0)])
        w.metric("engine_decode_collective_hidden_share", "gauge",
                 "Fraction of the per-step ring wire time the overlap "
                 "schedule hides under compute (measured on TPU, "
                 "analytic in dryrun); 0 until estimate_hidden_share() "
                 "has run",
                 [("", round(getattr(
                     engine, "decode_collective_hidden_share", 0.0), 4))])

    # Decode-step phase attribution (fused fast-path observability).
    # attn/sample are populated by engine.profile_decode_phases() — a
    # bench/admin probe, never run on scrape — so they read 0.0 until a
    # profile has run.  host_gap is a live EMA updated at every decode
    # reconcile and is the one to alert on: it should sit near 0 when
    # dispatch-ahead hides device latency.
    path = getattr(engine, "decode_path", "unknown")
    w.metric("engine_decode_path_info", "gauge",
             "Selected decode attention path (1 = active)",
             [(f'{{path="{path}"}}', 1)])
    w.metric("engine_decode_attn_ms", "gauge",
             "Profiled per-step paged-attention cost at long context",
             [("", round(getattr(engine, "decode_attn_ms", 0.0), 4))])
    w.metric("engine_decode_sample_ms", "gauge",
             "Profiled per-step on-device sampling cost",
             [("", round(getattr(engine, "decode_sample_ms", 0.0), 4))])
    w.metric("engine_decode_host_gap_ms", "gauge",
             "EMA of host time blocked per decode/spec reconcile "
             "(~0 when dispatch-ahead hides device latency)",
             [("", round(getattr(engine, "decode_host_gap_ms", 0.0), 4))])

    # Prefill fast-path attribution, mirroring the decode trio: which
    # path the engine selected (flash paged-prefill kernel vs dense XLA),
    # how long prefill calls take, and which bucket sizes production
    # actually dispatches (the 4096/8192 rungs exist only on flash).
    ppath = getattr(engine, "prefill_path", "dense")
    w.metric("engine_prefill_path_info", "gauge",
             "Selected prefill attention path (1 = active)",
             [(f'{{path="{ppath}"}}', 1)])
    w.metric("engine_prefill_attn_ms", "gauge",
             "EMA of per-prefill-call wall time (dispatch to reconcile), "
             "admission and chunk rounds alike",
             [("", round(getattr(engine, "prefill_attn_ms", 0.0), 4))])
    bucket_rounds = getattr(engine, "prefill_bucket_rounds", {})
    if bucket_rounds:
        w.metric("engine_prefill_bucket_rounds_total", "counter",
                 "Prefill rounds dispatched per bucket size (admission "
                 "and chunk rounds)",
                 [(f'{{bucket="{b}"}}', n)
                  for b, n in sorted(bucket_rounds.items())])

    # Prometheus histogram: cumulative buckets + sum + count.
    cumulative = 0
    samples = []
    for le, n in zip(engine.ttft_buckets, engine.ttft_counts):
        cumulative += n
        samples.append((f'_bucket{{le="{le}"}}', cumulative))
    cumulative += engine.ttft_counts[-1]
    samples.append(('_bucket{le="+Inf"}', cumulative))
    w.metric("engine_ttft_seconds", "histogram",
             "Time to first token per request", samples)
    w.lines.append(f"{_PREFIX}_engine_ttft_seconds_sum {engine.ttft_sum}")
    w.lines.append(f"{_PREFIX}_engine_ttft_seconds_count {engine.ttft_count}")


def _latency_histograms(w: _Writer, engine) -> None:
    """Per-SLO-class latency histograms (observability.metrics), with
    trace-id exemplars in OpenMetrics mode.  Families appear once a class
    has at least one observation; absent class labels mean "no traffic of
    that class yet", matching the per-class EMA NaN convention above."""
    hists = (
        ("request_ttft_seconds",
         "Time to first token per request, by SLO class",
         getattr(engine, "hist_ttft", None)),
        ("request_e2e_seconds",
         "Submit-to-final-token latency per request, by SLO class",
         getattr(engine, "hist_e2e", None)),
        ("request_queue_wait_seconds",
         "Queue wait before admission per request, by SLO class",
         getattr(engine, "hist_queue_wait", None)),
        ("decode_step_seconds",
         "Per-token decode segment time (segment wall time / steps), "
         "by SLO class",
         getattr(engine, "hist_decode_step", None)),
    )
    for name, help_, hist in hists:
        if hist is not None:
            w.histogram(name, help_, hist)


_HEALTH_STATES = ("healthy", "degraded", "draining", "unhealthy")


def _resilience_metrics(w: _Writer, engine, service) -> None:
    """Health state machine + failure-recovery counters, plus the
    SLO-class admission/eviction/brownout gauges (resilience/slo.py)."""
    from k8s_llm_monitor_tpu_torch.resilience.slo import BROWNOUT_NAMES, SLO_CLASSES

    if service is not None:
        state = service.health.state()
        w.metric("health_state", "gauge",
                 "Live health state (1 = current state)",
                 [(f'{{state="{s}"}}', 1 if s == state else 0)
                  for s in _HEALTH_STATES])
        w.metric("sheds_total", "counter",
                 "Submissions refused by load shedding",
                 [("", service.health.sheds)])
        w.metric("shed_total", "counter",
                 "Submissions refused by class-aware load shedding, "
                 "by SLO class",
                 [(f'{{class="{c}"}}',
                   service.shed_count_by_class.get(c, 0))
                  for c in SLO_CLASSES])
        bsnap = service.brownout.snapshot()
        w.metric("brownout_state", "gauge",
                 "Brownout ladder rung (1 = current rung); degraded "
                 "disables hedging/spec-decode and clamps batch budgets, "
                 "draining pauses diagnosis triggers",
                 [(f'{{state="{s}"}}', 1 if i == bsnap["level"] else 0)
                  for i, s in enumerate(BROWNOUT_NAMES)])
        w.metric("brownout_escalations_total", "counter",
                 "Brownout rung increases (immediate on health decline)",
                 [("", bsnap["escalations"])])
        w.metric("brownout_recoveries_total", "counter",
                 "Brownout rung decreases (one rung per recovery dwell)",
                 [("", bsnap["recoveries"])])
    w.metric("engine_watchdog_trips_total", "counter",
             "Dispatch watchdog expirations (pipeline resets)",
             [("", engine.watchdog_trips)])
    w.metric("engine_dispatch_failures_total", "counter",
             "Dispatch or reconcile failures recovered by the engine",
             [("", engine.dispatch_failures)])
    w.metric("engine_deadline_expired_total", "counter",
             "Requests failed by deadline/queue-TTL enforcement",
             [("", engine.deadline_expired)])
    w.metric("engine_requeues_total", "counter",
             "Slots recompute-requeued after a pipeline reset",
             [("", engine.requeues)])
    w.metric("engine_slot_wait_seconds", "gauge",
             "EMA of queue wait before a request wins a slot "
             "(load-shedding signal)",
             [("", round(engine.slot_wait_ema_s, 6))])
    # Per-class admission/latency EMAs.  A class with no sample yet emits
    # an explicit NaN (the constrained_decode_overhead_ms pattern): the
    # fleet router proxies replica /metrics, so an absent label would
    # silently mix "never measured" into the 0.0 population across
    # replicas.  Counters stay 0-valued — zero events IS the measurement.
    w.metric("queue_wait_ms", "gauge",
             "EMA of queue wait before a slot, by SLO class "
             "(NaN = no admission of this class yet)",
             [(f'{{class="{c}"}}',
               round(engine.slot_wait_ema_by_class[c] * 1000.0, 3)
               if c in engine.slot_wait_ema_by_class else float("nan"))
              for c in SLO_CLASSES])
    w.metric("engine_ttft_ema_seconds", "gauge",
             "EMA of time to first token, by SLO class "
             "(NaN = no completion of this class yet)",
             [(f'{{class="{c}"}}',
               round(engine.ttft_ema_by_class[c], 6)
               if c in engine.ttft_ema_by_class else float("nan"))
              for c in SLO_CLASSES])
    w.metric("preemptions_total", "counter",
             "Recompute-preemptions (involuntary KV pressure + voluntary "
             "class eviction), by evicted lane's SLO class",
             [(f'{{class="{c}"}}', engine.preemptions_by_class.get(c, 0))
              for c in SLO_CLASSES])
    w.metric("engine_brownout_clamps_total", "counter",
             "Batch max_tokens clamps applied while degraded or worse",
             [("", engine.brownout_clamps)])


_LIFECYCLE_STATES = ("serving", "rebuilding", "terminating", "stopped",
                     "failed")


def _lifecycle_metrics(w: _Writer, sup) -> None:
    """Crash-safe lifecycle: supervisor restarts + journal replay."""
    snap = sup.snapshot()
    w.metric("lifecycle_state", "gauge",
             "Serving lifecycle state (1 = current state)",
             [(f'{{state="{s}"}}', 1 if s == snap["state"] else 0)
              for s in _LIFECYCLE_STATES])
    w.metric("engine_restarts_total", "counter",
             "Engine rebuilds after a dead/wedged step loop",
             [("", snap["restarts"])])
    w.metric("journal_replayed_total", "counter",
             "Requests re-admitted from the journal or in-process tracking "
             "(rebuild replay + warm start)",
             [("", snap["replayed_total"])])
    w.metric("journal_bytes", "gauge",
             "Request WAL size on disk across live segments",
             [("", snap["journal_bytes"])])


def _kube_breaker_metrics(w: _Writer, breaker) -> None:
    states = ("closed", "open", "half-open")
    state = breaker.state
    w.metric("kube_breaker_state", "gauge",
             "Kube apiserver circuit breaker state (1 = current state)",
             [(f'{{state="{s}"}}', 1 if s == state else 0) for s in states])
    w.metric("kube_breaker_trips_total", "counter",
             "Times the apiserver circuit breaker opened",
             [("", breaker.trips)])
    w.metric("kube_breaker_rejections_total", "counter",
             "Apiserver calls refused while the breaker was open",
             [("", breaker.rejections)])


def _manager_metrics(w: _Writer, manager) -> None:
    w.metric("collections_total", "counter",
             "Metrics collection cycles completed",
             [("", manager.collect_count)])
    w.metric("collection_duration_seconds", "gauge",
             "Duration of the most recent collection cycle",
             [("", round(manager.last_collect_duration, 6))])
    snap = manager.get_latest_snapshot()
    w.metric("snapshot_nodes", "gauge", "Nodes in the latest snapshot",
             [("", len(snap.node_metrics))])
    w.metric("snapshot_pods", "gauge", "Pods in the latest snapshot",
             [("", len(snap.pod_metrics))])
    w.metric("snapshot_network_pairs", "gauge",
             "Probed pod pairs in the latest snapshot",
             [("", len(snap.network_metrics))])
    w.metric("snapshot_uavs", "gauge", "UAVs in the latest snapshot",
             [("", len(manager.get_uav_metrics()))])


def _fleet_metrics(w: _Writer, router) -> None:
    """Fleet-tier gauges (router role): per-replica dispatch state plus
    the router's hedging/failover/affinity counters."""
    snap = router.registry.snapshot()
    ready, inflight, hit_rate, dispatches, failures = [], [], [], [], []
    ages, roles, draining = [], [], []
    for rid, rep in sorted(snap.items()):
        label = f'{{replica="{rid}"}}'
        ready.append((label, 1 if rep["ready"] else 0))
        inflight.append((label, rep["inflight"]))
        hit_rate.append((label, rep["prefix_hit_rate"]))
        dispatches.append((label, rep["dispatches"]))
        failures.append((label, rep["failures"]))
        age = rep.get("probe_age_s")
        ages.append((label, age if age is not None else float("nan")))
        role = rep.get("role", "unified")
        roles.append((f'{{replica="{rid}",role="{role}"}}', 1))
        draining.append((label, 1 if rep.get("draining") else 0))
    if ready:
        w.metric("fleet_replica_ready", "gauge",
                 "Replica readiness as the router sees it", ready)
        w.metric("fleet_replica_inflight", "gauge",
                 "Router-side requests in flight per replica", inflight)
        w.metric("fleet_replica_prefix_hit_rate", "gauge",
                 "Prefix-cache hit rate from the replica's last stats probe",
                 hit_rate)
        w.metric("fleet_replica_dispatches_total", "counter",
                 "Requests the router dispatched to each replica",
                 dispatches)
        w.metric("fleet_replica_failures_total", "counter",
                 "Dispatch/stream failures the router observed per replica",
                 failures)
        # NaN = never probed, not "0 seconds ago" — a frozen stats row
        # must read as stale, never fresh (the scraper marks replicas
        # stale past stale_after_probes × probe interval).
        w.metric("fleet_scrape_age_s", "gauge",
                 "Seconds since each replica's last completed stats probe "
                 "(NaN = never probed)", ages)
        # Disaggregation: the role is a label, the value is a
        # constant 1 — join on {replica} to slice any fleet metric by role.
        w.metric("fleet_replica_role", "gauge",
                 "Replica serving role (prefill/decode/unified) as an "
                 "info-style gauge", roles)
        w.metric("fleet_replica_draining", "gauge",
                 "1 while the replica announces draining (router stops "
                 "dispatching; in-flight streams finish)", draining)
    c = router.counters()
    w.metric("fleet_affinity_hits_total", "counter",
             "Dispatches that landed on the policy's preferred replica",
             [("", c["affinity_hits"])])
    w.metric("fleet_affinity_spills_total", "counter",
             "Dispatches diverted off the preferred replica (saturation or "
             "breaker)", [("", c["affinity_spills"])])
    w.metric("fleet_hedges_fired_total", "counter",
             "Hedged dispatches fired after the EMA-p95 TTFT delay",
             [("", c["hedges_fired"])])
    w.metric("fleet_hedges_won_total", "counter",
             "Hedged dispatches whose second replica produced the first "
             "token", [("", c["hedges_won"])])
    w.metric("fleet_failovers_total", "counter",
             "Mid-stream failovers (replica died; request resumed "
             "elsewhere)", [("", c["failovers"])])
    w.metric("fleet_sheds_total", "counter",
             "Requests refused because no replica would take them",
             [("", c["sheds"])])
    w.metric("fleet_hedge_delay_seconds", "gauge",
             "Current hedge trigger delay (EMA-p95 of TTFT)",
             [("", round(router.hedge_delay_s(), 6))])
    # Cross-replica prefix migration.  All outcomes are emitted
    # 0-valued from the start so rate() works before the first attempt;
    # unexpected outcome strings (future engine verdicts) still show up.
    mig = dict(c.get("prefix_migrations") or {})
    outcomes = ["installed", "cached", "miss", "owner_down",
                "incompatible", "nospace", "error"]
    outcomes += sorted(o for o in mig if o not in outcomes)
    w.metric("fleet_prefix_migrations_total", "counter",
             "Prefix migrations attempted on affinity misses, by outcome "
             "(installed = pages moved instead of re-prefilling)",
             [(f'{{outcome="{o}"}}', mig.get(o, 0)) for o in outcomes])
    # Disaggregated prefill→decode handoffs.  Landing outcomes
    # (decode/local/replay) and failure causes share one family: the
    # causes explain why a handoff degraded to local decode.  All known
    # outcomes pre-seed at 0 so rate() works before the first handoff.
    hand = dict(c.get("handoffs") or {})
    h_outcomes = ["decode", "local", "replay", "no_decode", "owner_down",
                  "miss", "torn", "install_timeout", "nospace",
                  "incompatible", "dispatch_failed", "error"]
    h_outcomes += sorted(o for o in hand if o not in h_outcomes)
    w.metric("fleet_handoffs_total", "counter",
             "Prefill->decode handoff attempts by landing (decode = "
             "disaggregated, local = degraded to prefill replica, replay "
             "= owner died) and by failure cause",
             [(f'{{outcome="{o}"}}', hand.get(o, 0)) for o in h_outcomes])
    w.metric("fleet_drain_sweeps_total", "counter",
             "Prefixes exported off draining replicas to their new "
             "rendezvous owners", [("", c.get("drain_sweeps", 0))])


def _autoscaler_metrics(w: _Writer, ctl) -> None:
    """Elasticity controller accounting: every decision — applied,
    errored, or refused by a hysteresis gate — is a counted outcome."""
    totals = dict(ctl.counters()["actions_total"])
    # Pre-seed the cells dashboards alert on, keep any others.
    seeds = [(role, direction, outcome)
             for role in ("prefill", "decode", "unified")
             for direction in ("up", "down")
             for outcome in ("applied", "refused_cooldown", "refused_dwell")]
    for key in seeds:
        totals.setdefault(key, 0)
    w.metric("autoscale_actions_total", "counter",
             "Autoscale decisions by role, direction (up/down/rebalance) "
             "and outcome (applied, error, or the refusing gate)",
             [(f'{{role="{r}",direction="{d}",outcome="{o}"}}', n)
              for (r, d, o), n in sorted(totals.items())])
    w.metric("autoscale_breaker_open", "gauge",
             "1 while the controller's executor breaker is open "
             "(decisions refused, not retried)",
             [("", 1 if ctl.breaker.state == "open" else 0)])


def _remediation_metrics(w: _Writer, rem) -> None:
    """Closed-loop remediation accounting: every plan outcome (including
    every refusing gate), per-verb breaker state, and verification
    results — the observe-only default still counts ``proposed``."""
    from k8s_llm_monitor_tpu_torch.remediation.executor import (
        OUTCOMES,
        VERIFY_RESULTS,
    )
    from k8s_llm_monitor_tpu_torch.remediation.plans import PLAN_VERBS

    c = rem.counters()
    plans = dict(c["plans_total"])
    for verb in PLAN_VERBS:
        for outcome in OUTCOMES:
            plans.setdefault((verb, outcome), 0)
    w.metric("remediation_plans_total", "counter",
             "Action plans by verb and outcome (proposed, executed, error, "
             "or the refusing gate: approval/breaker/rate/replay)",
             [(f'{{verb="{v}",outcome="{o}"}}', n)
              for (v, o), n in sorted(plans.items())])
    w.metric("remediation_breaker_open", "gauge",
             "1 while the verb's executor circuit breaker is open "
             "(plans refused, not retried)",
             [(f'{{verb="{v}"}}', open_)
              for v, open_ in sorted(c["breaker_open"].items())])
    verify = dict(c["verify_total"])
    for result in VERIFY_RESULTS:
        verify.setdefault(result, 0)
    w.metric("remediation_verify_total", "counter",
             "Post-action verification turns by result (resolved = "
             "condition cleared AND the verdict is non-critical)",
             [(f'{{result="{r}"}}', n) for r, n in sorted(verify.items())])


def _diagnosis_metrics(w: _Writer, pipeline, backend) -> None:
    """Standing diagnosis pipeline: verdict counts by severity,
    trigger→verdict lag, and the constrained-decode tax on the engine."""
    if pipeline is not None:
        counts = pipeline.store.counts()
        w.metric("diagnosis_verdicts_total", "counter",
                 "Verdicts published by the diagnosis pipeline, by severity",
                 [(f'{{severity="{s}"}}', counts.get(s, 0))
                  for s in pipeline.store.SEVERITIES])
        w.metric("diagnosis_pipeline_lag_ms", "gauge",
                 "Burst trigger to published verdict latency "
                 "(most recent verdict)",
                 [("", round(pipeline.store.lag_ms(), 3))])
        w.metric("diagnosis_triggers_total", "counter",
                 "Warning-event bursts that fired the pipeline",
                 [("", pipeline.triggers_total)])
        w.metric("diagnosis_queries_total", "counter",
                 "Root-cause LLM queries the pipeline ran",
                 [("", pipeline.queries_total)])
        w.metric("diagnosis_errors_total", "counter",
                 "Pipeline diagnosis attempts that raised",
                 [("", pipeline.errors_total)])
        w.metric("diagnosis_context_events", "gauge",
                 "Cluster events held in the context ring buffer",
                 [("", len(pipeline.context))])
    # Emitted UNCONDITIONALLY: the fleet router proxies replica /metrics,
    # and a gauge that only the local-engine backend emits would silently
    # mix populations across a scrape of mixed backends.  Backends that do
    # not track the EMA (remote/openai/template, or a router with no
    # engine) emit an explicit NaN marker instead of being absent, so
    # dashboards can tell "not measured here" from "never scraped".
    overhead = getattr(backend, "constrained_decode_overhead_ms", None)
    w.metric("constrained_decode_overhead_ms", "gauge",
             "Per-token decode cost of FSM-constrained sampling vs "
             "free decoding (EMA delta; 0 until both paths observed; "
             "NaN when this backend does not measure it)",
             [("", round(overhead, 4) if overhead is not None
               else float("nan"))])


def _device_metrics(w: _Writer) -> None:
    """The cards ``torch.cuda`` sees: memory the caching allocator holds
    and the card's total, per device, under the JAX exporter's names."""
    try:
        import torch

        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    except Exception:  # noqa: BLE001 — no backend available
        return
    samples_used, samples_total = [], []
    for i in range(n):
        label = f'{{device="{i}",kind="{torch.cuda.get_device_name(i)}"}}'
        samples_used.append((label, torch.cuda.memory_allocated(i)))
        samples_total.append((label, torch.cuda.mem_get_info(i)[1]))
    if samples_used:
        w.metric("device_memory_used_bytes", "gauge",
                 "Accelerator (HBM) bytes in use", samples_used)
    if samples_total:
        w.metric("device_memory_limit_bytes", "gauge",
                 "Accelerator (HBM) byte limit", samples_total)
    w.metric("devices", "gauge", "Visible accelerator devices",
             [("", n)])


def _telemetry_metrics(w: _Writer, scraper) -> None:
    """Signal-scraper self-accounting (the telemetry plane watching
    itself): scrape cadence health and store occupancy."""
    c = scraper.counters()
    w.metric("telemetry_scrapes_total", "counter",
             "Signal-scraper sampling passes completed",
             [("", c["scrapes_total"])])
    w.metric("telemetry_scrape_errors_total", "counter",
             "Signal-scraper passes that raised and were dropped",
             [("", c["scrape_errors_total"])])
    w.metric("telemetry_anomalies_total", "counter",
             "Anomaly flags raised by the derived-signal layer "
             "(edge-triggered, per target+flag cooldown)",
             [("", c["anomalies_total"])])
    w.metric("telemetry_evicted_targets_total", "counter",
             "Departed fleet targets whose series were GC'd from the "
             "store (membership-lifecycle probe-leak cleanup)",
             [("", c.get("evicted_targets_total", 0))])
    t = scraper.store.totals()
    w.metric("telemetry_series", "gauge",
             "Live time series held by the in-process store",
             [("", t["series"])])
    w.metric("telemetry_points_total", "counter",
             "Points recorded into the time-series store",
             [("", t["points_total"])])
    w.metric("telemetry_dropped_series_total", "counter",
             "Series refused because the store hit max_series",
             [("", t["dropped_series_total"])])


def _tenant_metrics(w: _Writer, srv) -> None:
    """Per-tenant admission/quota/KV families (resilience/tenancy.py).

    Cardinality discipline: the ``tenant`` label is capped at the top-K
    tenants by admitted requests plus ONE aggregate ``other`` bucket
    (always emitted, 0 when nothing spilled), so an abusive client
    minting fresh tenant ids can grow the scrape by exactly nothing.
    K comes from ``config.tenancy.top_k_metrics``.
    """
    gov = getattr(srv, "governor", None)
    if gov is None:
        return
    snap = gov.snapshot()
    tcfg = getattr(getattr(srv, "config", None), "tenancy", None)
    top_k = max(1, int(getattr(tcfg, "top_k_metrics", 8) or 8))
    # Device-resident prefix-cache blocks join on the same label set.
    blocks: dict[str, int] = {}
    svc = srv.engine_service() if hasattr(srv, "engine_service") else None
    engine = getattr(svc, "engine", None)
    tier_fn = getattr(engine, "kv_tier_stats", None)
    if callable(tier_fn):
        blocks = dict(tier_fn().get("tenant_blocks") or {})
    ranked = sorted(snap, key=lambda t: (-snap[t]["admitted"], t))
    shown = ranked[:top_k]
    spilled = ranked[top_k:]
    kv_spilled = [t for t in blocks if t not in shown]

    def rows(per_tenant, other_value):
        return ([(f'{{tenant="{t}"}}', per_tenant(t)) for t in shown]
                + [('{tenant="other"}', other_value)])

    w.metric("tenant_requests_total", "counter",
             "Requests admitted per tenant (top-K by volume; the rest "
             "aggregate under tenant=\"other\")",
             rows(lambda t: snap[t]["admitted"],
                  sum(snap[t]["admitted"] for t in spilled)))
    w.metric("tenant_shed_total", "counter",
             "Refusals charged per tenant: quota 429s plus SLO-class "
             "sheds downstream of admission",
             rows(lambda t: snap[t]["sheds"],
                  sum(snap[t]["sheds"] for t in spilled)))
    w.metric("tenant_kv_blocks", "gauge",
             "Distinct device prefix-cache blocks resident per tenant "
             "namespace (the fairness cap's accounting)",
             rows(lambda t: blocks.get(t, 0),
                  sum(blocks[t] for t in kv_spilled)))
    w.metric("tenant_quota_remaining", "gauge",
             "Token-quota bucket level per tenant (-1 = unlimited; NaN "
             "for the aggregate bucket — levels do not sum)",
             rows(lambda t: snap[t]["quota_remaining"], float("nan")))


def _tracing_metrics(w: _Writer) -> None:
    """Tracer + flight-recorder self-accounting."""
    from k8s_llm_monitor_tpu_torch.observability.flight import get_flight_recorder
    from k8s_llm_monitor_tpu_torch.observability.tracing import get_tracer

    tracer = get_tracer()
    w.metric("trace_sample_rate", "gauge",
             "Configured head-sampling rate (K8SLLM_TRACE_SAMPLE)",
             [("", tracer.sample)])
    w.metric("trace_spans_recorded_total", "counter",
             "Spans pushed to the in-process ring",
             [("", tracer.recorded)])
    rec = get_flight_recorder()
    w.metric("flight_dumps_total", "counter",
             "Flight-recorder artifacts written on failure edges",
             [("", rec.dumps)])
    w.metric("flight_dump_errors_total", "counter",
             "Flight-recorder dump attempts that hit an OSError",
             [("", rec.dump_errors)])


def render_prometheus(srv: "MonitorServer", openmetrics: bool = False) -> str:
    w = _Writer(openmetrics=openmetrics)
    w.metric("build_info", "gauge", "Monitor build info",
             [('{version="1.0.0"}', 1)])
    engine = None
    service = None
    if srv.analysis is not None:
        backend = getattr(srv.analysis, "backend", None)
        engine = getattr(backend, "engine", None)
        service = getattr(backend, "service", None)
    if engine is not None:
        _engine_metrics(w, engine)
        _latency_histograms(w, engine)
        _resilience_metrics(w, engine, service)
    supervisor = srv.engine_supervisor() if hasattr(
        srv, "engine_supervisor") else None
    if supervisor is not None:
        _lifecycle_metrics(w, supervisor)
    breaker = getattr(getattr(srv.client, "backend", None), "breaker", None)
    if breaker is not None:
        _kube_breaker_metrics(w, breaker)
    router = getattr(srv.analysis, "router", None)
    if router is not None:
        _fleet_metrics(w, router)
    autoscaler = getattr(srv, "autoscaler", None)
    if autoscaler is not None:
        _autoscaler_metrics(w, autoscaler)
    remediation = getattr(srv, "remediation", None)
    if remediation is not None:
        _remediation_metrics(w, remediation)
    if srv.manager is not None:
        _manager_metrics(w, srv.manager)
    backend = getattr(srv.analysis, "backend", None)
    pipeline = getattr(srv, "diagnosis", None)
    if pipeline is not None or backend is not None:
        _diagnosis_metrics(w, pipeline, backend)
    scraper = getattr(srv, "signals", None)
    if scraper is not None:
        _telemetry_metrics(w, scraper)
    _tenant_metrics(w, srv)
    _tracing_metrics(w)
    _device_metrics(w)
    # Render-time self-lint: a malformed family poisons the whole scrape
    # silently (Prometheus drops what it can't parse), so the exporter
    # counts its own format errors as a scrapeable metric.  The lint
    # family is appended after linting; it uses the same writer path that
    # every linted family went through.
    errors = lint_exposition("\n".join(w.lines) + "\n")
    if errors:  # pragma: no cover — a clean exporter never logs here
        import logging

        logging.getLogger("monitor.exporter").warning(
            "exposition lint: %s", "; ".join(errors[:5]))
    w.metric("exposition_lint_errors", "gauge",
             "Format errors the exporter found in its own output "
             "(0 = clean scrape)", [("", len(errors))])
    return w.render()
