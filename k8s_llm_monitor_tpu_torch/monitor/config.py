"""Typed configuration tree + YAML/env loader.

Parity target: ``reference/internal/config/config.go`` — same tree
(server / k8s / llm / storage / monitoring / metrics / analysis / logging,
config.go:12-102), same defaults (config.go:132-169), same env override
behavior (viper ``AutomaticEnv`` with ``.``→``_``, config.go:106-113, plus
the OPENAI_* aliases at config.go:172-182).

Differences by design: ``llm.provider`` gains the in-tree ``"tpu"`` value
(serving the Analysis Engine from the local engine, here the PyTorch one on
the GPU, instead of a remote OpenAI call) and an ``llm.tpu`` sub-block
selecting the model preset; the reference's remote-provider fields are kept
for the OpenAI-compatible fallback path.  The tree, its defaults and the
key names are the JAX package's, so one YAML file or environment configures
either package; ``LocalEngineBackend.from_config`` refuses the knobs the
port does not serve yet (``quantize`` int8/w8a8, ``checkpoint``,
``spec_k > 0``, ``mesh_shape``).
"""

from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass, field
from typing import Any

import yaml

#: Central registry of every *explicit* project-prefixed env key read
#: anywhere in the package.  Keys derived generically by ``_apply_env``
#: (config path ``fleet.role`` -> ``FLEET_ROLE``) are NOT listed — they
#: are computed from the dataclass tree.  Values are either a
#: ``Class.field`` the key overrides (validated against the package AST
#: by ``graftcheck --contracts``) or ``runtime:<module>`` for toggles
#: with no config field, owned and read by that module.  The env
#: contract checker enforces: every explicit read is registered, every
#: entry is read and documented, every target exists.
ENV_KEYS: dict[str, str] = {
    # engine kernel-path overrides (env wins over EngineConfig)
    "K8SLLM_KV_DTYPE": "EngineConfig.kv_dtype",
    "K8SLLM_PREFILL_PATH": "EngineConfig.prefill_path",
    "K8SLLM_DECODE_PATH": "EngineConfig.decode_path",
    "K8SLLM_TP_OVERLAP": "EngineConfig.tp_overlap",
    # reference-compat aliases (config.go:172-182)
    "OPENAI_API_KEY": "LLMConfig.api_key",
    "OPENAI_BASE_URL": "LLMConfig.base_url",
    # runtime toggles: no config field by design — they must work
    # before/without a loaded Config (crash paths, chaos drills, tests)
    "K8SLLM_TRACE_SAMPLE": "runtime:observability/tracing.py",
    "K8SLLM_TRACE_SEED": "runtime:observability/tracing.py",
    "K8SLLM_FLIGHT_DIR": "runtime:observability/flight.py",
    "K8SLLM_FAULTS": "runtime:resilience/faults.py",
    "K8SLLM_JOURNAL_FSYNC": "runtime:resilience/journal.py",
    "K8SLLM_LOCKCHECK": "runtime:devtools/lockcheck.py",
    "K8SLLM_LOCKCHECK_HOLD_MS": "runtime:devtools/lockcheck.py",
    "K8SLLM_TENANT_ENFORCE": "runtime:resilience/tenancy.py",
    "K8SLLM_TENANT_DEFAULT": "runtime:resilience/tenancy.py",
    "K8SLLM_REMEDIATE_APPROVE": "runtime:remediation/executor.py",
}


@dataclass
class ServerConfig:
    host: str = "0.0.0.0"
    port: int = 8080
    debug: bool = False


@dataclass
class K8sConfig:
    kubeconfig: str = ""
    namespace: str = "default"
    watch_namespaces: list[str] = field(default_factory=lambda: ["default"])


@dataclass
class TPULLMConfig:
    """In-tree inference backend knobs (new; no reference equivalent).  The
    block keeps the JAX package's name, ``llm.tpu``, so one config serves
    either package."""

    model: str = "llama-1b"  # preset name in models/config.py PRESETS
    checkpoint: str = ""  # HF checkpoint dir ('' => random-init dev weights)
    # "int8" = weight-only quantization; "w8a8" = int8 weights + dynamic
    # per-token activation int8; '' = bf16.  W8A8 is the JAX package's
    # serving default; the port serves only '' so far and refuses the
    # others by name (set LLM_TPU_QUANTIZE= to run it).
    quantize: str = "w8a8"
    mesh_shape: str = ""  # e.g. "1,1,8" for data,seq,model; '' => single chip
    max_batch: int = 32
    kv_blocks: int = 512
    # Persistent XLA compilation cache of the JAX package; the port has
    # no compilation cache and ignores it.  '' disables.
    compile_cache_dir: str = ".jax_cache"
    # Prompt-lookup speculative decoding draft length (serving/spec.py);
    # 0 disables.  Every sampling mode speculates (greedy bit-identically;
    # sampled — incl. top-k/top-p — distribution-exactly), emitting up to
    # spec_k+1 tokens per verify forward when the output quotes its
    # context.  ON by default for the monitor: diagnosis answers are
    # template-heavy (they quote pod names, container states, and log
    # lines straight out of the evidence prompt — exactly the regime
    # prompt-lookup drafts for), and the downside is bounded twice over:
    # the AcceptanceEMA kill-switch (spec_min_accept below) auto-disables
    # drafting per request class when measured acceptance cannot pay for
    # the verify forwards, and brownout (resilience/slo.py ladder) turns
    # speculation off wholesale under pressure.  Set 0 to opt out.  The
    # port has no speculative decoding yet and refuses spec_k > 0.
    spec_k: int = 4
    # Acceptance floor for the per-request-class speculative kill-switch
    # (serving/spec.py AcceptanceEMA): when a class's accepted-tokens-per-
    # lane-round EMA drops below this, drafting auto-disables for that
    # class (re-probing periodically).  Exported as `spec_accept_ema`.
    spec_min_accept: float = 1.2


@dataclass
class LLMConfig:
    provider: str = "tpu"  # "tpu" (in-tree) | "openai" | "template"
    api_key: str = ""
    base_url: str = ""
    model: str = "gpt-4"
    max_tokens: int = 2000
    temperature: float = 0.1
    timeout: int = 30
    tpu: TPULLMConfig = field(default_factory=TPULLMConfig)


@dataclass
class RedisConfig:
    host: str = "localhost"
    port: int = 6379
    password: str = ""
    db: int = 0


@dataclass
class PostgresConfig:
    host: str = "localhost"
    port: int = 5432
    user: str = ""
    password: str = ""
    database: str = ""


@dataclass
class StorageConfig:
    type: str = "memory"
    redis: RedisConfig = field(default_factory=RedisConfig)
    postgres: PostgresConfig = field(default_factory=PostgresConfig)


@dataclass
class MonitoringConfig:
    metrics_interval: int = 30
    event_retention: int = 168  # hours (ref config.go default)
    log_retention: int = 24  # hours (ref config.go default)


@dataclass
class MetricsConfig:
    enabled: bool = True
    collect_interval: int = 30
    namespaces: list[str] = field(default_factory=lambda: ["default"])
    enable_node: bool = True
    enable_pod: bool = True
    enable_network: bool = False
    enable_uav: bool = True
    enable_custom: bool = False
    cache_retention: int = 300
    max_pod_pairs: int = 5
    network_timeout: int = 10


@dataclass
class AnalysisConfig:
    enable_prediction: bool = True  # ref config.go default
    enable_auto_fix: bool = False
    max_context_events: int = 100
    # Embedding anomaly detector (analysis/anomaly.py): "" disables;
    # an ENCODER_PRESETS name ("tiny-encoder", "bge-large") random-inits;
    # a directory path loads a BertModel-family HF checkpoint.
    embedding_model: str = ""


@dataclass
class DiagnosisConfig:
    """Standing watcher→LLM diagnosis pipeline (diagnosis/pipeline.py).
    New; no reference equivalent — the reference never closed the
    monitor→LLM loop."""

    enabled: bool = True
    # Burst detector: >= burst_threshold Warning events inside window_s
    # triggers one root-cause query; cooldown_s suppresses immediate
    # re-triggers while the same incident keeps emitting events.
    burst_threshold: int = 5
    window_s: float = 60.0
    cooldown_s: float = 120.0
    # Context assembly bounds: the event ring the assembler selects from,
    # how many events each query includes (embedding top-k when
    # analysis.embedding_model is set, else the most recent), and the hard
    # character cap on the rendered context block.
    max_context_events: int = 64
    context_top_k: int = 8
    max_context_chars: int = 2000
    # Verdict ring exposed at GET /api/v1/diagnoses.
    history: int = 64
    # Multi-turn follow-up sessions (diagnosis/session.py): idle TTL and
    # the LRU cap on concurrently pinned session contexts.
    session_ttl_s: float = 600.0
    max_sessions: int = 16


@dataclass
class LifecycleConfig:
    """Crash-safe serving lifecycle (resilience/journal.py +
    serving/supervisor.py + cmd/server.py signal handlers).  New; no
    reference equivalent — the Go reference had no engine to supervise."""

    # Request WAL directory; '' disables journaling (the supervisor still
    # rebuilds and replays in-process requests).
    journal_dir: str = ""
    journal_fsync: str = "interval"  # always | interval | never
    journal_segment_mb: int = 4
    # SIGTERM/SIGINT: how long to wait for inflight generations before the
    # process exits.  Keep below the pod's terminationGracePeriodSeconds
    # minus the preStop sleep (deployments/monitor-server.yaml).
    drain_grace_s: float = 20.0
    # Supervisor: engine rebuilds allowed before giving up, and how stale
    # the step-loop heartbeat may go (with work pending) before the loop
    # counts as wedged.
    max_restarts: int = 3
    heartbeat_timeout_s: float = 30.0
    restart_backoff_s: float = 0.5


@dataclass
class FleetConfig:
    """Fleet tier (fleet/): router role fronting N engine replicas.
    New; no reference equivalent — the Go reference was single-process."""

    # Replica base URLs the router fronts, e.g.
    # "http://engine-0.engine:8080,http://engine-1.engine:8080"
    # (FLEET_REPLICAS env, comma-separated).  Empty = this process is a
    # plain replica; the router role refuses to start without it.
    replicas: list[str] = field(default_factory=list)
    policy: str = "affinity"  # affinity | least_loaded | round_robin
    # Prompt-prefix length (tokens) hashed for affinity routing; keep at
    # or above the shared cluster-context preamble so same-context queries
    # stay on the replica whose PrefixCache holds their pages.
    affinity_prefix_tokens: int = 64
    probe_interval_s: float = 5.0
    connect_timeout_s: float = 2.0
    read_timeout_s: float = 60.0
    # Per-replica circuit breaker (resilience/retry.py semantics).
    breaker_failures: int = 3
    breaker_cooldown_s: float = 5.0
    # Mid-stream failover budget per request.
    max_failovers: int = 2
    # Hedged dispatch: fire a second replica when the first shows no token
    # after the EMA-p95 TTFT delay (docs/fleet.md).  fixed_delay_s > 0
    # pins the delay (bench/tests); 0 uses the online estimate.
    hedge_enabled: bool = False
    hedge_min_delay_s: float = 0.05
    hedge_fixed_delay_s: float = 0.0
    # SLO-class routing (resilience/slo.py): batch requests only spill to
    # a non-affinity replica whose load score is below this fraction of
    # capacity; interactive requests always route least-loaded.
    batch_spill_threshold: float = 0.75
    # Disaggregation role of THIS process (FLEET_ROLE env on replicas):
    # "prefill" replicas take new prompts and hand the finished prefix to
    # a "decode" replica over the KVX1 migration path; "unified" does
    # both.  The router reads each replica's role from its stats
    # heartbeat — misconfigured or mixed fleets degrade to unified
    # dispatch, never to dropped requests (docs/fleet.md).
    role: str = "unified"  # prefill | decode | unified
    # Best-effort prefix handout when a replica announces draining: at
    # most this many cached prefixes are offered to their new rendezvous
    # owners via export_prefix/install_prefix before the replica leaves.
    drain_sweep_budget: int = 8


@dataclass
class TelemetryConfig:
    """Fleet telemetry plane (observability/timeseries.py + signals.py):
    the in-tree time-series store, the signal scraper, and the derived
    autoscaler/anomaly contract behind GET /api/v1/signals.  New; no
    reference equivalent."""

    enabled: bool = True
    # Scraper cadence and store bounds: points kept per series, series
    # allowed in the store (label-cardinality blast-radius cap).
    scrape_interval_s: float = 2.0
    ring_points: int = 512
    max_series: int = 2048
    # Default trailing window for derived signals and /api/v1/timeseries.
    window_s: float = 60.0
    ema_half_life_s: float = 10.0
    # scale_hint thresholds: per-class queue-token growth rate that reads
    # as "scale up", and the brownout dwell fraction (share of window
    # samples at rung >= degraded) that does the same.
    queue_growth_up_tok_s: float = 50.0
    brownout_dwell_up: float = 0.5
    # Per-class TTFT budgets (seconds) for sustained-breach detection.
    ttft_budget_interactive_s: float = 1.0
    ttft_budget_standard_s: float = 2.5
    ttft_budget_batch_s: float = 10.0
    # Anomaly edge-trigger cooldown per (target, flag), and whether
    # anomalies feed the diagnosis pipeline as self_monitor events.
    anomaly_cooldown_s: float = 30.0
    feed_diagnosis: bool = True
    # Replica probe-staleness multiple (router role): stats older than
    # this many probe intervals get NaN markers, not frozen values.
    stale_after_probes: float = 3.0
    # Trailing seconds of the series window snapshotted into flight-
    # recorder crash artifacts (v2 "signals" block).
    flight_window_s: float = 30.0


@dataclass
class AutoscaleConfig:
    """Elasticity controller (fleet/autoscaler.py): closes the telemetry
    plane's sense loop by acting on per-target ``scale_hint``s through
    per-role StatefulSet scale subresources (or an in-process LocalReplica
    pool under test).  New; no reference equivalent."""

    enabled: bool = False
    # Decision cadence (the controller also exposes a tick() seam so
    # tests drive it with a fake clock).
    interval_s: float = 10.0
    # Per-role replica bounds.  Unknown/unified targets count against the
    # "unified" role.
    min_prefill: int = 1
    max_prefill: int = 4
    min_decode: int = 1
    max_decode: int = 4
    min_unified: int = 1
    max_unified: int = 4
    # Hysteresis: scale-down requires the role's hints to agree "down"
    # continuously for the dwell; any executed action opens a cooldown
    # during which the controller refuses to act again.
    scale_down_dwell_s: float = 60.0
    cooldown_s: float = 30.0
    # Flap damping: more than this many per-role direction changes inside
    # the window refuses further actions until hints settle.
    flap_window_s: float = 120.0
    flap_max_flips: int = 3
    # Kube execution: per-role StatefulSet names under `namespace`;
    # every scale is issued dry-run first, then for real, through the
    # hardened client's retry/breaker path.
    namespace: str = "monitoring"
    statefulset_prefill: str = "engine-prefill"
    statefulset_decode: str = "engine-decode"
    statefulset_unified: str = "engine"
    dry_run_first: bool = True
    # Per-verb circuit breaker on the scale subresource.
    breaker_failures: int = 3
    breaker_cooldown_s: float = 30.0


@dataclass
class RemediationConfig:
    """Closed-loop remediation (remediation/executor.py): the diagnosis
    pipeline's plan stage plus the gated executor and verification turn.
    New; no reference equivalent — the Go reference stopped at verdicts."""

    # Plan stage on/off.  Enabled by default: plans are cheap, grammar
    # -bounded, and observe-only until `execute` (or a per-plan approval)
    # says otherwise.
    enabled: bool = True
    # The big switch: False (default) stores plans without touching the
    # cluster; an explicit POST /api/v1/remediations/<id>/approve still
    # executes that one plan.  True executes non-destructive plans
    # automatically (destructive verbs additionally need the approval
    # gate — K8SLLM_REMEDIATE_APPROVE=1 or per-plan approval).
    execute: bool = False
    # Every mutation is validated with a dry-run call first (server-side
    # dryRun=All on the real client, simulated validation on the fake).
    dry_run_first: bool = True
    # Post-action verification turn (session-pinned diagnosis + per-verb
    # state predicate) and its capped escalation ladder.
    verify: bool = True
    max_retries: int = 2
    # Per-verb circuit breaker around the cluster backend.
    breaker_failures: int = 3
    breaker_cooldown_s: float = 30.0
    # Rate limits: minimum seconds between executions of the same verb,
    # and of the same (verb, target) pair.
    verb_interval_s: float = 5.0
    target_interval_s: float = 60.0
    # Idempotency: an identical (verb, target, trigger) execution within
    # this window is refused as a replay (supervisor replays, double
    # approvals).
    replay_window_s: float = 300.0
    # Stored-record ring size for GET /api/v1/remediations.
    history: int = 128


@dataclass
class TenancyConfig:
    """Multi-tenant admission quotas + KV fairness (resilience/tenancy.py).
    New; no reference equivalent — the Go reference had no admission layer
    to partition."""

    enabled: bool = True
    # Refuse over-quota requests with tenant-tagged 429s.  False keeps the
    # full per-tenant accounting but never refuses (single-tenant default);
    # K8SLLM_TENANT_ENFORCE=1 flips enforcement on without a config change.
    enforce: bool = True
    # Per-tenant request-rate bucket; rate 0 leaves the dimension
    # unlimited (burst 0 derives from the rate).
    requests_per_s: float = 0.0
    request_burst: float = 0.0
    # Per-tenant generated-token quota bucket: max_tokens is reserved at
    # admission and the unused remainder refunded at settlement.
    tokens_per_s: float = 0.0
    token_burst: float = 0.0
    # KV fairness: fraction of resident prefix-cache blocks (device) /
    # bytes (host tier) one tenant may hold while another is resident;
    # 1.0 disables the cap.
    max_kv_share: float = 1.0
    # Exporter cardinality cap: per-tenant metric families emit the top-K
    # tenants by admitted requests plus one aggregate "other" bucket.
    top_k_metrics: int = 8
    # Governor state cap: longest-idle tenants with nothing in flight are
    # evicted past this many distinct tenants.
    max_tenants: int = 1024


@dataclass
class LoggingConfig:
    level: str = "info"
    format: str = "json"  # ref config.go default
    output: str = "stdout"


@dataclass
class Config:
    server: ServerConfig = field(default_factory=ServerConfig)
    k8s: K8sConfig = field(default_factory=K8sConfig)
    llm: LLMConfig = field(default_factory=LLMConfig)
    storage: StorageConfig = field(default_factory=StorageConfig)
    monitoring: MonitoringConfig = field(default_factory=MonitoringConfig)
    metrics: MetricsConfig = field(default_factory=MetricsConfig)
    analysis: AnalysisConfig = field(default_factory=AnalysisConfig)
    diagnosis: DiagnosisConfig = field(default_factory=DiagnosisConfig)
    lifecycle: LifecycleConfig = field(default_factory=LifecycleConfig)
    fleet: FleetConfig = field(default_factory=FleetConfig)
    telemetry: TelemetryConfig = field(default_factory=TelemetryConfig)
    autoscale: AutoscaleConfig = field(default_factory=AutoscaleConfig)
    remediation: RemediationConfig = field(
        default_factory=RemediationConfig)
    tenancy: TenancyConfig = field(default_factory=TenancyConfig)
    logging: LoggingConfig = field(default_factory=LoggingConfig)


def _coerce(value: str, target: Any) -> Any:
    """Coerce an env-var string to the type of the current field value."""
    if isinstance(target, bool):
        return value.strip().lower() in ("1", "true", "yes", "on")
    if isinstance(target, int):
        return int(value)
    if isinstance(target, float):
        return float(value)
    if isinstance(target, list):
        return [v.strip() for v in value.split(",") if v.strip()]
    return value


def _apply_dict(obj: Any, data: dict[str, Any], path: str = "") -> None:
    """Recursively overlay a parsed-YAML dict onto the dataclass tree."""
    for key, value in (data or {}).items():
        norm = str(key).replace("-", "_")
        if not dataclasses.is_dataclass(obj) or not hasattr(obj, norm):
            continue  # unknown keys are ignored, like viper
        current = getattr(obj, norm)
        if dataclasses.is_dataclass(current) and isinstance(value, dict):
            _apply_dict(current, value, f"{path}{norm}.")
        elif value is not None:
            if isinstance(current, (bool, int, float)) and isinstance(value, str):
                value = _coerce(value, current)
            setattr(obj, norm, value)


def _apply_env(obj: Any, prefix: str = "") -> None:
    """Overlay env vars: config path ``a.b.c`` reads ``A_B_C``.

    Mirrors viper AutomaticEnv with the ``.``→``_`` replacer
    (ref config.go:106-113).
    """
    for f in dataclasses.fields(obj):
        current = getattr(obj, f.name)
        env_key = (prefix + f.name).upper()
        if dataclasses.is_dataclass(current):
            _apply_env(current, prefix + f.name + "_")
        elif env_key in os.environ:
            setattr(obj, f.name, _coerce(os.environ[env_key], current))


def load_config(path: str | None = None) -> Config:
    """Load config: defaults ← YAML file ← env vars ← OPENAI_* aliases.

    Precedence and alias behavior match ref config.go:105-182. A missing
    file is not an error when ``path`` is empty/None (defaults-only boot,
    the reference's dev mode); an explicit path that doesn't exist raises.
    """
    cfg = Config()
    if path:
        with open(path) as fh:
            data = yaml.safe_load(fh) or {}
        _apply_dict(cfg, data)
    _apply_env(cfg)
    # Compatibility aliases (ref config.go:172-182).
    if os.environ.get("OPENAI_API_KEY"):
        cfg.llm.api_key = os.environ["OPENAI_API_KEY"]
    if os.environ.get("OPENAI_BASE_URL"):
        cfg.llm.base_url = os.environ["OPENAI_BASE_URL"]
    # Keep metrics namespaces in sync with watch namespaces when only the
    # k8s block was configured (the reference wires cfg.K8s.WatchNamespaces
    # into the manager directly, cmd/server/main.go:62-72).
    if cfg.k8s.watch_namespaces and cfg.metrics.namespaces == ["default"]:
        cfg.metrics.namespaces = list(cfg.k8s.watch_namespaces)
    return cfg
