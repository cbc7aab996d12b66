"""Fleet router: policy-ranked dispatch with hedging and mid-stream failover.

Routing policies (pluggable, ranked candidate lists — dispatch walks the
ranking so a refused/overloaded candidate falls through to the next):

* ``round_robin`` — baseline rotation; the control arm for the affinity
  hit-rate comparison.
* ``least_loaded`` — weighted load score from each replica's stats
  snapshot: queue-token backlog + busy-slot pressure + router-side inflight.
* ``affinity`` — rendezvous (highest-random-weight) hashing on a
  prompt-prefix digest, so same-prefix requests land on the replica whose
  ``PrefixCache`` already holds their pages.  Saturated preferred replicas
  spill to the least-loaded ranking (hot cache is worth nothing if the
  request queues behind a full batch).

Hedged dispatch (token-level path): when the primary has produced no token
after the EMA-p95 TTFT delay, a second replica gets the same request; the
first to produce a token wins and the loser is cancelled.  p95 is estimated
online as ``m + k·d`` where ``m`` is a TTFT EMA and ``d`` an EMA of absolute
deviation (for a normal tail, sigma ≈ 1.4826·MAD and p95 ≈ m + 1.645·sigma
≈ m + 2.45·d; ``k`` defaults to 3.0 for safety against hedging storms).

Mid-stream failover (token-level path): a replica that dies mid-generation
resolves its handle with an error result; the pump resubmits to the next
healthy replica with the already-streamed tokens folded into the prompt and
``max_tokens`` trimmed by the emitted count — the same idempotent-replay
contract as ``serving/supervisor.py`` — so the caller's stream continues
with zero duplicated and zero lost tokens.

The text-level path (``query``/``query_stream``/``analyze`` over
``HTTPReplica``) gets the same policy ranking and failover; a resumed SSE
stream suppresses the already-delivered character prefix.  Hedging is
token-level only (an SSE generator has no timed ``next``).

Disaggregated roles (docs/fleet.md "Disaggregated roles & autoscaling"):
when the fleet advertises both ``prefill``- and ``decode``-role replicas,
a new request prefills (plus first token) on a prefill replica, then the
finished prefix is streamed to a decode replica over the ``KVX1``
export/install migration path and the remaining budget continues there.
Every handoff failure mode — ``nospace``, ``incompatible``, owner death
mid-transfer, install timeout, a torn blob — degrades to unified-style
local decode on the prefill replica (whose KV already holds the prompt,
so the continuation is a prefix hit, not a re-prefill); a dead prefill
replica falls through to the normal failover replay.  A request is never
dropped by the handoff ladder.
"""

from __future__ import annotations

import dataclasses
import hashlib
import itertools
import logging
import threading
import time
from typing import Optional

from k8s_llm_monitor_tpu_torch.devtools.lockcheck import guarded_by, make_lock
from k8s_llm_monitor_tpu_torch.fleet.registry import Candidate, ReplicaRegistry
from k8s_llm_monitor_tpu_torch.fleet.replica import ReplicaUnavailable
from k8s_llm_monitor_tpu_torch.observability.tracing import Tracer, get_tracer
from k8s_llm_monitor_tpu_torch.resilience.errors import OverloadedError
from k8s_llm_monitor_tpu_torch.resilience.retry import CircuitOpen
from k8s_llm_monitor_tpu_torch.resilience.tenancy import (
    DEFAULT_TENANT,
    TenantGovernor,
    normalize_tenant,
)
from k8s_llm_monitor_tpu_torch.serving.engine import (GenerationResult,
                                                      SamplingParams)
from k8s_llm_monitor_tpu_torch.serving.kv_tier import BlobError
from k8s_llm_monitor_tpu_torch.serving.service import RequestHandle

logger = logging.getLogger("fleet.router")


# ---------------------------------------------------------------------------
# Routing policies
# ---------------------------------------------------------------------------


def _load_score(c: Candidate) -> float:
    """Weighted least-loaded signal: queue-token backlog dominates, busy
    slots and router-side inflight break ties (a replica with a full batch
    but an empty queue still beats one with a backlog)."""
    slot_pressure = (c.stats.busy_slots / c.stats.total_slots
                     if c.stats.total_slots else 0.0)
    return c.stats.queue_tokens + 64.0 * slot_pressure + 16.0 * c.inflight


def _slot_utilization(c: Candidate) -> float:
    return (c.stats.busy_slots / c.stats.total_slots
            if c.stats.total_slots else 0.0)


class RoutingPolicy:
    name = "base"

    def rank(self, candidates: list[Candidate],
             digest: bytes) -> list[Candidate]:
        raise NotImplementedError

    def preferred(self, candidates: list[Candidate],
                  digest: bytes) -> Optional[str]:
        """The replica this policy would ideally use (affinity accounting);
        None when the policy has no cache-topology preference."""
        return None


class RoundRobinPolicy(RoutingPolicy):
    name = "round_robin"

    def __init__(self) -> None:
        self._turn = itertools.count()

    def rank(self, candidates: list[Candidate],
             digest: bytes) -> list[Candidate]:
        if not candidates:
            return []
        ordered = sorted(candidates, key=lambda c: c.replica_id)
        k = next(self._turn) % len(ordered)
        return ordered[k:] + ordered[:k]


class LeastLoadedPolicy(RoutingPolicy):
    name = "least_loaded"

    def rank(self, candidates: list[Candidate],
             digest: bytes) -> list[Candidate]:
        return sorted(candidates,
                      key=lambda c: (_load_score(c), c.replica_id))


class PrefixAffinityPolicy(RoutingPolicy):
    """Rendezvous hashing on the prompt-prefix digest.

    Every (digest, replica) pair gets a deterministic weight; the highest
    weight wins.  Replica loss only remaps the keys that pointed at the
    lost replica (the consistent-hashing property), so a failover doesn't
    shuffle the whole fleet's cache topology.  A saturated winner spills to
    the least-loaded order, counted by the router as an affinity spill.
    """

    name = "affinity"

    @staticmethod
    def _weight(digest: bytes, replica_id: str) -> bytes:
        return hashlib.sha256(digest + replica_id.encode()).digest()

    @staticmethod
    def _saturated(c: Candidate) -> bool:
        return (c.stats.total_slots > 0
                and c.stats.busy_slots >= c.stats.total_slots
                and c.stats.queue_tokens > 0)

    def rank(self, candidates: list[Candidate],
             digest: bytes) -> list[Candidate]:
        ranked = sorted(candidates,
                        key=lambda c: self._weight(digest, c.replica_id),
                        reverse=True)
        if len(ranked) > 1 and self._saturated(ranked[0]):
            relief = [c for c in ranked[1:] if not self._saturated(c)]
            if relief:
                spill = sorted(relief,
                               key=lambda c: (_load_score(c), c.replica_id))
                rest = [c for c in ranked if c not in spill]
                ranked = spill + rest
        return ranked

    def preferred(self, candidates: list[Candidate],
                  digest: bytes) -> Optional[str]:
        if not candidates:
            return None
        best = max(candidates,
                   key=lambda c: self._weight(digest, c.replica_id))
        return best.replica_id


POLICIES = {
    "round_robin": RoundRobinPolicy,
    "least_loaded": LeastLoadedPolicy,
    "affinity": PrefixAffinityPolicy,
}


# ---------------------------------------------------------------------------
# Router
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class HedgeConfig:
    enabled: bool = False
    min_delay_s: float = 0.05     # floor: never hedge faster than this
    fixed_delay_s: float = 0.0    # >0 pins the delay (bench/tests)
    p95_mult: float = 3.0         # k in delay = ttft_ema + k * dev_ema
    cold_delay_s: float = 0.5     # before any TTFT sample exists


@dataclasses.dataclass
class _Flight:
    """Pump-thread state for one fleet-level request (mirrors the
    supervisor's ``_Tracked``: everything needed to replay elsewhere)."""

    rid: str
    prompt_ids: list[int]
    sampling: SamplingParams
    deadline_s: float
    digest: bytes
    slo_class: str
    tenant: str
    handle: RequestHandle               # fleet-level, what the caller holds
    inner: Optional[RequestHandle]      # current replica-level handle
    replica_id: str
    emitted: list[int] = dataclasses.field(default_factory=list)
    prior: list[int] = dataclasses.field(default_factory=list)
    attempts: int = 0                   # failovers consumed
    cancelled: bool = False
    dispatch_t0: float = 0.0
    # TraceContext minted at submit time (child of the caller's context
    # when one exists).  The pump/hedge threads re-enter it (Tracer.use)
    # before every replica call so failover replays and hedge legs join
    # the originating trace — the router's half of the one-merged-trace
    # contract.  Its own span ("router.request") is recorded when the
    # flight resolves, so children never point at an unrecorded parent.
    trace: object = None
    submit_t0: float = 0.0
    # Disaggregation: this flight was dispatched to a prefill-role replica
    # with a 1-token budget; on clean completion the pump runs the handoff
    # ladder instead of finishing the stream.
    pending_decode: bool = False


_DONE = object()
_HANDOFF = object()


@guarded_by("_lock", "dispatches", "completed", "failed", "sheds",
            "failovers", "hedges_fired", "hedges_won", "affinity_hits",
            "affinity_spills", "_migrations", "_ttft_m", "_ttft_dev",
            "_handoffs", "_recent_prefixes", "drain_sweeps")
class FleetRouter:
    """Routes requests over a ``ReplicaRegistry`` with the selected policy,
    per-replica circuit breaking, optional hedging, and mid-stream
    failover.  Token-level entry point is ``submit()`` (returns a
    ``RequestHandle``-compatible ticket); text-level entry points are
    ``query``/``query_stream``/``analyze``."""

    def __init__(self, registry: ReplicaRegistry, policy: str = "affinity",
                 hedge: HedgeConfig | None = None, max_failovers: int = 2,
                 affinity_prefix_tokens: int = 64,
                 stall_timeout_s: float = 120.0,
                 batch_spill_threshold: float = 0.75,
                 migrate_prefixes: bool = True,
                 drain_sweep_budget: int = 8,
                 governor: TenantGovernor | None = None):
        if policy not in POLICIES:
            raise ValueError(
                f"unknown policy {policy!r} (have {sorted(POLICIES)})")
        self.registry = registry
        self.policy = POLICIES[policy]()
        self.hedge = hedge or HedgeConfig()
        # Router-owned tenant governor: quota is charged ONCE per logical
        # request here — replica-level dispatches (hedge legs, failover
        # replays, decode handoffs) are fan-out of the same reservation
        # and must never re-charge it, so replicas behind a router run
        # without a governor of their own.
        self.governor = governor
        self.max_failovers = max_failovers
        self.affinity_prefix_tokens = affinity_prefix_tokens
        self.stall_timeout_s = stall_timeout_s
        # SLO-class routing (resilience/slo.py): batch only spills off its
        # affinity target onto replicas below this slot utilization.
        self.batch_spill_threshold = batch_spill_threshold
        self._ids = itertools.count()
        # counters (exporter gauges)
        self.dispatches = 0
        self.completed = 0
        self.failed = 0
        self.sheds = 0
        self.failovers = 0
        self.hedges_fired = 0
        self.hedges_won = 0
        self.affinity_hits = 0
        self.affinity_spills = 0
        # Prefix migration: on an affinity miss, fetch the shared KV
        # pages from the policy-preferred owner and install them on the
        # actual target before dispatch (serving/kv_tier.py framing) so
        # the spilled request still skips its re-prefill.  Outcome
        # counters feed prefix_migrations_total{outcome}.
        self.migrate_prefixes = migrate_prefixes
        self._migrations: dict[str, int] = {}
        # Prefill->decode handoff outcomes (fleet_handoffs_total{outcome}):
        # "decode" = continuation landed on a decode replica with the
        # installed prefix; "local" = degraded to local decode on the
        # prefill replica; failure-cause keys (nospace / incompatible /
        # owner_down / miss / torn / install_timeout / error / no_decode /
        # dispatch_failed) count WHY a handoff degraded.
        self._handoffs: dict[str, int] = {}
        # Recently-dispatched prefix heads: digest -> (head tokens, last
        # replica, tenant).  The drain sweep reads this to proactively
        # offer a draining replica's cached prefixes to their new
        # rendezvous owners; bounded LRU so it never grows with traffic.
        self._recent_prefixes: dict[bytes, tuple[list[int], str, str]] = {}
        self._recent_prefixes_cap = 128
        self.drain_sweep_budget = drain_sweep_budget
        self.drain_sweeps = 0
        # online TTFT stats for the hedge delay
        self._ttft_m: float | None = None
        self._ttft_dev: float = 0.0
        self._ttft_alpha = 0.2
        # Created last (lockcheck construction rule).
        self._lock = make_lock("fleet.router")
        # Membership lifecycle hooks: offer a draining replica's prefixes
        # to their replacements; GC affinity memory for removed replicas.
        registry.subscribe_drain(self._drain_sweep)
        registry.subscribe_remove(self.forget_replica)

    # -- shared plumbing -------------------------------------------------

    def _bump(self, name: str, by: int = 1) -> None:
        with self._lock:
            setattr(self, name, getattr(self, name) + by)

    def counters(self) -> dict:
        with self._lock:
            return {
                "dispatches": self.dispatches,
                "completed": self.completed,
                "failed": self.failed,
                "sheds": self.sheds,
                "failovers": self.failovers,
                "hedges_fired": self.hedges_fired,
                "hedges_won": self.hedges_won,
                "affinity_hits": self.affinity_hits,
                "affinity_spills": self.affinity_spills,
                "prefix_migrations": dict(self._migrations),
                "handoffs": dict(self._handoffs),
                "drain_sweeps": self.drain_sweeps,
            }

    def telemetry_sample(self) -> dict:
        """The signal scraper's fleet input: every replica's last probe
        row plus the probe cadence the staleness rule is judged against.
        One registry lock pass, no HTTP — the probe loop already paid
        for the data."""
        return {
            "replicas": self.registry.snapshot(),
            "probe_interval_s": self.registry.probe_interval_s,
            "counters": self.counters(),
        }

    def replicas(self) -> list[tuple[str, object]]:
        """(replica_id, Replica) pairs — the cross-replica trace merge in
        ``GET /api/v1/trace/<id>`` walks every registered replica, ready
        or not (a replica that died mid-request still holds its spans)."""
        out = []
        for rid in self.registry.ids():
            entry = self.registry.get(rid)
            if entry is not None:
                out.append((rid, entry.replica))
        return out

    def _token_digest(self, prompt_ids: list[int],
                      tenant: str = DEFAULT_TENANT) -> bytes:
        # Tenant folded in so affinity routing mirrors the tenant-seeded
        # prefix-cache key space: two tenants sharing a prompt have
        # *different* cached prefixes, so they are different affinity keys.
        head = prompt_ids[: self.affinity_prefix_tokens]
        return hashlib.sha256(
            tenant.encode() + b"\x00"
            + b",".join(str(t).encode() for t in head)).digest()

    @staticmethod
    def _text_digest(question: str) -> bytes:
        return hashlib.sha256(question[:256].encode()).digest()

    def _note_ttft(self, dt: float) -> None:
        a = self._ttft_alpha
        with self._lock:
            if self._ttft_m is None:
                self._ttft_m = dt
                self._ttft_dev = dt / 2.0
            else:
                self._ttft_m += a * (dt - self._ttft_m)
                self._ttft_dev += a * (abs(dt - self._ttft_m)
                                       - self._ttft_dev)

    def hedge_delay_s(self) -> float:
        """Current hedge trigger: EMA-p95 of TTFT (see module docstring),
        or the configured fixed delay."""
        if self.hedge.fixed_delay_s > 0:
            return self.hedge.fixed_delay_s
        with self._lock:
            m, dev = self._ttft_m, self._ttft_dev
        if m is None:
            return max(self.hedge.min_delay_s, self.hedge.cold_delay_s)
        return max(self.hedge.min_delay_s, m + self.hedge.p95_mult * dev)

    def _ranked(self, digest: bytes, need_tokens: bool,
                slo_class: str = "standard") -> list[Candidate]:
        cands = [c for c in self.registry.candidates()
                 if (c.replica.supports_tokens if need_tokens
                     else c.replica.supports_query)]
        # Interactive traffic beats cache locality: always least-loaded,
        # whatever the configured policy, so an operator query never queues
        # behind the affinity target's backlog.
        if slo_class == "interactive":
            return sorted(cands,
                          key=lambda c: (_load_score(c), c.replica_id))
        ranked = self.policy.rank(cands, digest)
        # Batch keeps its affinity head (prefix pages are most valuable for
        # the long contexts batch carries) but only spills onto replicas
        # with headroom — saturating a second replica with background work
        # would steal slots from the classes above it.
        if slo_class == "batch" and len(ranked) > 1:
            ranked = [ranked[0]] + [
                c for c in ranked[1:]
                if _slot_utilization(c) < self.batch_spill_threshold]
        return ranked

    def _account_affinity(self, digest: bytes, chosen: str,
                          candidates: list[Candidate]) -> None:
        pref = self.policy.preferred(candidates, digest)
        if pref is None:
            return
        self._bump("affinity_hits" if chosen == pref else "affinity_spills")

    # -- prefix migration (affinity miss -> move the pages, not the work) -

    def _bump_migration(self, outcome: str) -> None:
        with self._lock:
            self._migrations[outcome] = self._migrations.get(outcome, 0) + 1

    def _bump_handoff(self, outcome: str) -> None:
        with self._lock:
            self._handoffs[outcome] = self._handoffs.get(outcome, 0) + 1

    def _maybe_migrate_prefix(self, digest: bytes, prompt_ids: list[int],
                              ranked: list[Candidate],
                              tenant: str = DEFAULT_TENANT) -> None:
        """When dispatch is about to land off the affinity owner, pull the
        owner's cached KV pages for this prompt and install them on the
        actual target first — the target's prefill then hits its prefix
        cache instead of recomputing the shared span.  Every failure mode
        degrades to plain re-prefill; this path must never lose a request.
        """
        if not self.migrate_prefixes or len(ranked) < 2:
            return
        target = ranked[0]
        pref = self.policy.preferred(ranked, digest)
        if pref is None or pref == target.replica_id:
            return  # hit: the pages are already where the request lands
        owner = next((c for c in ranked if c.replica_id == pref), None)
        if (owner is None or not owner.replica.supports_kv_migration
                or not target.replica.supports_kv_migration):
            return
        tracer = get_tracer()
        t_mig = time.monotonic()

        def _span(outcome: str, status: str = "ok") -> None:
            tracer.record(
                "router.migrate_prefix", t_mig, time.monotonic(),
                tracer.current(), status=status,
                attrs={"owner": pref, "target": target.replica_id,
                       "outcome": outcome})

        try:
            blob = owner.replica.fetch_prefix(prompt_ids, tenant=tenant)
        except ReplicaUnavailable:
            self._bump_migration("owner_down")
            _span("owner_down", status="error")
            return
        except Exception:  # noqa: BLE001 — migration is best-effort
            logger.exception("prefix fetch from %s failed", pref)
            self._bump_migration("error")
            _span("fetch_error", status="error")
            return
        if blob is None:
            self._bump_migration("miss")
            _span("miss")
            return
        try:
            outcome = target.replica.install_prefix(blob, tenant=tenant)
        except Exception:  # noqa: BLE001 — migration is best-effort
            logger.exception("prefix install on %s failed",
                             target.replica_id)
            self._bump_migration("error")
            _span("install_error", status="error")
            return
        self._bump_migration(str(outcome))
        _span(str(outcome))
        if outcome == "installed":
            logger.info("migrated prefix %s... %s -> %s",
                        digest[:4].hex(), pref, target.replica_id)

    # -- membership lifecycle: drain sweep + removal GC ------------------

    def _note_prefix(self, digest: bytes, prompt_ids: list[int],
                     replica_id: str,
                     tenant: str = DEFAULT_TENANT) -> None:
        head = list(prompt_ids[: self.affinity_prefix_tokens])
        with self._lock:
            self._recent_prefixes.pop(digest, None)
            self._recent_prefixes[digest] = (head, replica_id, tenant)
            while len(self._recent_prefixes) > self._recent_prefixes_cap:
                self._recent_prefixes.pop(
                    next(iter(self._recent_prefixes)))

    def forget_replica(self, replica_id: str) -> None:
        """Removal GC: drop the affinity-memory entries that point at a
        replica that left the fleet (wired to ``registry.subscribe_remove``
        — the registry already dropped its breaker/inflight state)."""
        with self._lock:
            for dig in [d for d, (_, owner, _t)
                        in self._recent_prefixes.items()
                        if owner == replica_id]:
                del self._recent_prefixes[dig]

    def _drain_sweep(self, replica_id: str) -> None:
        """Best-effort prefix handout on a replica's draining edge: offer
        up to ``drain_sweep_budget`` of its recently-served prefixes to
        their new rendezvous owners (the draining replica no longer wins
        affinity — ``candidates()`` excludes it — so without the sweep
        every one of its hot prefixes re-prefills cold elsewhere).  Every
        failure mode is swallowed: draining must never block on this."""
        entry = self.registry.get(replica_id)
        if (entry is None
                or not getattr(entry.replica, "supports_kv_migration",
                               False)):
            return
        with self._lock:
            owned = [(dig, head, ten) for dig, (head, owner, ten)
                     in self._recent_prefixes.items()
                     if owner == replica_id]
        cands = [c for c in self.registry.candidates()
                 if c.replica.supports_kv_migration
                 and c.replica_id != replica_id]
        if not cands or not owned:
            return
        moved = 0
        for dig, head, ten in owned:
            if moved >= self.drain_sweep_budget:
                break
            pref = self.policy.preferred(cands, dig)
            target = next((c for c in cands if c.replica_id == pref), None)
            if target is None:
                ranked = self.policy.rank(cands, dig)
                target = ranked[0] if ranked else None
            if target is None:
                break
            try:
                blob = entry.replica.fetch_prefix(head, tenant=ten)
            except ReplicaUnavailable:
                self._bump_migration("owner_down")
                break  # owner died mid-drain: nothing more to offer
            except Exception:  # noqa: BLE001 — sweep is best-effort
                logger.exception("drain sweep fetch from %s failed",
                                 replica_id)
                self._bump_migration("error")
                break
            if blob is None:
                self._bump_migration("miss")
                continue
            try:
                outcome = str(target.replica.install_prefix(blob,
                                                            tenant=ten))
            except Exception:  # noqa: BLE001 — sweep is best-effort
                logger.exception("drain sweep install on %s failed",
                                 target.replica_id)
                self._bump_migration("error")
                continue
            self._bump_migration(outcome)
            if outcome in ("installed", "cached"):
                moved += 1
                with self._lock:
                    self._recent_prefixes[dig] = (head, target.replica_id,
                                                  ten)
        if moved:
            self._bump("drain_sweeps", moved)
            logger.info("drain sweep moved %d prefixes off %s",
                        moved, replica_id)

    # -- token-level dispatch -------------------------------------------

    def _dispatch_tokens(self, ranked: list[Candidate],
                         prompt_ids: list[int], sampling: SamplingParams,
                         request_id: str, deadline_s: float,
                         exclude: frozenset[str] | set[str] = frozenset(),
                         slo_class: str = "standard",
                         tenant: str = DEFAULT_TENANT):
        """Try candidates in rank order; returns (replica_id, handle) or
        (None, last_error).  Breaker gates each attempt."""
        last_exc: Exception | None = None
        for cand in ranked:
            if cand.replica_id in exclude:
                continue
            entry = self.registry.get(cand.replica_id)
            if entry is None:
                continue
            try:
                entry.breaker.before_call()
            except CircuitOpen as exc:
                last_exc = exc
                continue
            try:
                handle = cand.replica.generate(
                    prompt_ids, sampling, request_id=request_id,
                    deadline_s=deadline_s, slo_class=slo_class,
                    tenant=tenant)
            except OverloadedError as exc:
                entry.breaker.record_success()  # alive, just shedding
                last_exc = exc
                continue
            except Exception as exc:  # noqa: BLE001 — routing fact
                entry.breaker.record_failure()
                self.registry.mark_unready(cand.replica_id, str(exc))
                last_exc = exc
                continue
            self.registry.note_dispatch(cand.replica_id)
            self._bump("dispatches")
            return cand.replica_id, handle
        return None, last_exc

    def submit(self, prompt_ids: list[int],
               sampling: SamplingParams | None = None,
               request_id: str | None = None,
               deadline_s: float = 0.0,
               slo_class: str = "standard",
               tenant: str = DEFAULT_TENANT) -> RequestHandle:
        """Admit one generation into the fleet.  Raises ``OverloadedError``
        when no replica will take it (counted as a shed); otherwise returns
        a handle whose stream survives replica death transparently.
        Tenant quota is charged here, once — every downstream replica
        dispatch (hedge, failover, handoff) rides the same reservation."""
        sampling = sampling or SamplingParams()
        tenant = normalize_tenant(tenant)
        rid = request_id or f"fleet-{next(self._ids)}"
        if self.governor is not None:
            # Raises a tenant-tagged OverloadedError (HTTP 429) before any
            # replica sees the request; reserves max_tokens until settle.
            self.governor.admit(
                tenant, rid, max_tokens=sampling.max_tokens,
                prompt_bytes=len(prompt_ids) * 4, slo_class=slo_class)
        tracer = get_tracer()
        # A fresh child of the caller's context (set by the HTTP server
        # from traceparent), or a new root when the router is where this
        # request's trace begins.
        parent = tracer.current()
        trace = Tracer.child(parent) if parent is not None \
            else tracer.new_trace()
        tracer.bind(rid, trace)
        digest = self._token_digest(prompt_ids, tenant)
        t_rank = time.monotonic()
        ranked = self._ranked(digest, need_tokens=True, slo_class=slo_class)
        # Disaggregated dispatch: with both roles present, the request
        # prefills (plus first token) on a prefill replica and the pump
        # hands the finished prefix to a decode replica.  A fleet missing
        # either role — or a 1-token request, where there is nothing to
        # hand off — dispatches unified.
        prefill_ranked = [c for c in ranked if c.stats.role == "prefill"]
        disagg = (bool(prefill_ranked)
                  and any(c.stats.role == "decode" for c in ranked)
                  and sampling.max_tokens > 1)
        chosen, handle = (None, None)
        with tracer.use(trace):
            if disagg:
                chosen, handle = self._dispatch_tokens(
                    prefill_ranked, prompt_ids,
                    dataclasses.replace(sampling, max_tokens=1),
                    f"{rid}-a0", deadline_s, slo_class=slo_class,
                    tenant=tenant)
                if chosen is None:
                    disagg = False  # no prefill taker: degrade to unified
            if not disagg and ranked and chosen is None:
                self._maybe_migrate_prefix(digest, prompt_ids, ranked,
                                           tenant)
                chosen, handle = self._dispatch_tokens(
                    ranked, prompt_ids, sampling, f"{rid}-a0", deadline_s,
                    slo_class=slo_class, tenant=tenant)
        if chosen is None:
            self._bump("sheds")
            if self.governor is not None:
                # Nothing was generated: release the token reservation.
                # The request-rate charge stands — a shed storm still
                # counts against the tenant's rate.
                self.governor.settle(rid)
                self.governor.note_shed(tenant)
            self._end_flight_span_at(trace, rid, t_rank, "error",
                                     outcome="shed")
            err = handle  # last error from dispatch, or None when empty
            if isinstance(err, OverloadedError):
                raise err
            raise OverloadedError(
                f"no replica available ({err or 'fleet empty'})",
                retriable=True, retry_after_s=1.0, slo_class=slo_class,
                request_id=rid, tenant=tenant)
        self._account_affinity(digest, chosen, ranked)
        self._note_prefix(digest, prompt_ids, chosen, tenant)
        tracer.record("router.dispatch", t_rank, time.monotonic(), trace,
                      attrs={"request_id": rid, "replica": chosen,
                             "attempt": 0, "class": slo_class,
                             "disaggregated": disagg})

        flight = _Flight(
            rid=rid, prompt_ids=list(prompt_ids), sampling=sampling,
            deadline_s=deadline_s, digest=digest, slo_class=slo_class,
            tenant=tenant,
            handle=RequestHandle(rid, eos_id=None), inner=handle,
            replica_id=chosen, dispatch_t0=time.monotonic(), trace=trace,
            submit_t0=t_rank, pending_decode=disagg)
        flight.handle._cancel_fn = lambda _rid: self._cancel_flight(flight)
        threading.Thread(target=self._pump, args=(flight,),
                         name=f"fleet-pump-{rid}", daemon=True).start()
        return flight.handle

    @staticmethod
    def _end_flight_span_at(trace, rid: str, t0: float, status: str,
                            **attrs) -> None:
        """Record the flight's own span (the context's span id itself, so
        every child span recorded under it has a real parent)."""
        if trace is None:
            return
        attrs["request_id"] = rid
        get_tracer().record(
            "router.request", t0, time.monotonic(), trace, status=status,
            span_id=trace.span_id, parent_id=trace.parent_id, attrs=attrs)

    def _end_flight_span(self, fl: _Flight, status: str, **attrs) -> None:
        self._end_flight_span_at(fl.trace, fl.rid, fl.submit_t0, status,
                                 replica=fl.replica_id,
                                 attempts=fl.attempts,
                                 tokens=len(fl.emitted), **attrs)

    def _cancel_flight(self, fl: _Flight) -> None:
        fl.cancelled = True
        inner = fl.inner
        if inner is not None:
            inner.cancel()

    def _settle_flight(self, fl: _Flight) -> None:
        """Finalize the tenant reservation on a terminal outcome: exactly
        the tokens streamed to the caller stay charged (``fl.emitted`` is
        appended once per delivered token, across every replica
        incarnation), the rest of the reservation is refunded.  Hedge
        losers and failover replays never touched the governor, so there
        is nothing to reconcile beyond this one settlement."""
        if self.governor is None:
            return
        self.governor.note_delivered(fl.rid, len(fl.emitted))
        self.governor.settle(fl.rid)

    # -- pump: stream, hedge, fail over ---------------------------------

    def _pump(self, fl: _Flight) -> None:
        # Pump threads are born context-less: re-enter the flight's trace
        # so the replica calls below (failover resubmits, hedge legs,
        # their HTTP hops) carry the originating traceparent.
        tracer = get_tracer()
        try:
            with tracer.use(fl.trace):
                while True:
                    outcome = self._consume(fl)
                    if outcome is _DONE:
                        return
                    if outcome is _HANDOFF:
                        # Prefill leg finished cleanly: hand the prefix to
                        # a decode replica (or degrade to local decode) —
                        # the prefill replica's inflight/breaker credit was
                        # already settled in _consume.
                        err = self._handoff(fl)
                        if err is None:
                            continue
                        return self._fail(fl, err)
                    # Replica died mid-generation: fold emitted tokens into
                    # the prompt, trim the budget, resubmit elsewhere
                    # (supervisor replay contract, fleet-wide).
                    self.registry.note_done(fl.replica_id, ok=False)
                    self.registry.mark_unready(fl.replica_id, str(outcome))
                    self._bump("failovers")
                    fl.attempts += 1
                    fl.pending_decode = False  # replay carries full budget
                    if fl.cancelled:
                        return self._fail(fl, "cancelled")
                    if fl.attempts > self.max_failovers:
                        return self._fail(
                            fl, f"failover budget exhausted: {outcome}")
                    remaining = fl.sampling.max_tokens - len(fl.emitted)
                    if remaining <= 0:
                        return self._finish_trimmed(fl)
                    replay = dataclasses.replace(
                        fl.sampling, max_tokens=remaining)
                    t_fo = time.monotonic()
                    ranked = self._ranked(fl.digest, need_tokens=True,
                                          slo_class=fl.slo_class)
                    chosen, handle = self._dispatch_tokens(
                        ranked, fl.prompt_ids + fl.emitted, replay,
                        f"{fl.rid}-a{fl.attempts}", fl.deadline_s,
                        exclude={fl.replica_id}, slo_class=fl.slo_class,
                        tenant=fl.tenant)
                    if chosen is None:
                        return self._fail(
                            fl, f"no healthy replica for failover ({handle})")
                    tracer.record(
                        "router.failover", t_fo, time.monotonic(), fl.trace,
                        attrs={"request_id": fl.rid, "from": fl.replica_id,
                               "to": chosen, "attempt": fl.attempts,
                               "tokens_folded": len(fl.emitted),
                               "cause": str(outcome)[:200]})
                    logger.info(
                        "request %s failed over %s -> %s after %d tokens",
                        fl.rid, fl.replica_id, chosen, len(fl.emitted))
                    fl.prior = list(fl.emitted)
                    fl.replica_id, fl.inner = chosen, handle
                    fl.dispatch_t0 = time.monotonic()
        except Exception:  # noqa: BLE001 — a pump must never strand a caller
            logger.exception("pump for %s crashed", fl.rid)
            self._fail(fl, "router pump error")

    def _consume(self, fl: _Flight):
        """Stream one replica incarnation into the fleet handle.  Returns
        ``_DONE`` on a delivered final result or an error-message string
        when the replica died and a failover should run."""
        inner = fl.inner
        first = not fl.emitted
        # Hedging doubles device work for one request: never for batch
        # traffic, and not while the primary reports brownout (degraded or
        # worse) — the extra dispatch is exactly what it is shedding.
        # (A pending-decode prefill leg never hedges either: its 1-token
        # budget is the short leg, and a hedge would race the full budget.)
        if (self.hedge.enabled and first and fl.attempts == 0
                and not fl.cancelled and fl.slo_class != "batch"
                and not fl.pending_decode
                and not self._replica_browned_out(fl.replica_id)):
            hedged = self._maybe_hedge(fl)
            if hedged is not None:
                inner = hedged
        last_progress = time.monotonic()
        while True:
            try:
                tok = inner.poll_token(timeout=0.2)
            except TimeoutError:
                if (time.monotonic() - last_progress > self.stall_timeout_s
                        and not fl.cancelled):
                    inner.cancel()
                    return "replica stalled (no token within "\
                           f"{self.stall_timeout_s:.0f}s)"
                continue
            last_progress = time.monotonic()
            if tok is None:
                res = inner.result(timeout=10.0)
                if res.finish_reason == "error" and not fl.cancelled:
                    return res.error or "replica failed"
                if (fl.pending_decode and not fl.cancelled
                        and res.finish_reason == "length"
                        and fl.sampling.max_tokens > len(fl.emitted)):
                    # The 1-token prefill budget is spent but the caller's
                    # budget isn't: this is the handoff point, not the end
                    # of the stream.  (EOS inside the prefill leg — a
                    # "stop" finish — completes normally below.)
                    self.registry.note_done(fl.replica_id, ok=True)
                    return _HANDOFF
                fl.handle._replay_prefix = list(fl.prior)
                self._settle_flight(fl)
                fl.handle._push([], res)
                self.registry.note_done(
                    fl.replica_id, ok=res.finish_reason != "error")
                self._bump("completed")
                self._end_flight_span(
                    fl, "error" if res.finish_reason == "error" else "ok",
                    finish_reason=res.finish_reason)
                return _DONE
            if not fl.emitted and not fl.prior:
                self._note_ttft(time.monotonic() - fl.dispatch_t0)
            fl.emitted.append(tok)
            fl.handle._push([tok], None)

    def _handoff(self, fl: _Flight) -> Optional[str]:
        """The prefill→decode handoff ladder.  The prefill replica P has
        finished the prompt (plus first token); its KV pool holds the full
        prefix.  Rungs, in order:

        1. Export the prefix from P and install it on the best decode
           candidate D; on ``installed``/``cached``, dispatch the
           remaining budget to D (suffix-only admission — the DistServe
           move).
        2. Any handoff failure (``nospace``, ``incompatible``, owner
           death, install timeout, torn blob, no decode candidate, D
           refusing the dispatch) degrades to **local decode on P** —
           P's prefix cache still holds the prompt, so this is a hit,
           not a re-prefill.
        3. P itself dead: the normal failover ranking over everyone else
           (a plain replay — the only rung that re-prefills).

        Returns None with ``fl.inner`` streaming the continuation, or an
        error message only when no replica anywhere would take it."""
        fl.pending_decode = False
        prefill_id = fl.replica_id
        remaining = fl.sampling.max_tokens - len(fl.emitted)
        cont = dataclasses.replace(fl.sampling, max_tokens=remaining)
        prompt = fl.prompt_ids + fl.emitted
        t0 = time.monotonic()
        ranked = self._ranked(fl.digest, need_tokens=True,
                              slo_class=fl.slo_class)
        entry = self.registry.get(prefill_id)
        owner = entry.replica if entry is not None else None
        decode_ranked = [c for c in ranked
                         if c.stats.role == "decode"
                         and c.replica_id != prefill_id
                         and c.replica.supports_kv_migration]

        cause: Optional[str] = None
        chosen, handle = None, None
        if not decode_ranked:
            cause = "no_decode"
        elif owner is None or not getattr(owner, "supports_kv_migration",
                                          False):
            cause = "owner_down"
        else:
            target = decode_ranked[0]
            blob = None
            try:
                blob = owner.fetch_prefix(prompt, tenant=fl.tenant)
            except ReplicaUnavailable:
                cause = "owner_down"
            except Exception:  # noqa: BLE001 — handoff is best-effort
                logger.exception("handoff fetch from %s failed", prefill_id)
                cause = "error"
            if cause is None and blob is None:
                cause = "miss"
            if cause is None:
                try:
                    outcome = str(target.replica.install_prefix(
                        blob, tenant=fl.tenant))
                except BlobError:
                    cause = "torn"
                except ReplicaUnavailable:
                    # Covers both install timeouts and a target that died
                    # mid-transfer — either way the blob never landed.
                    cause = "install_timeout"
                except Exception:  # noqa: BLE001 — handoff is best-effort
                    logger.exception("handoff install on %s failed",
                                     target.replica_id)
                    cause = "error"
                else:
                    if outcome not in ("installed", "cached"):
                        cause = outcome  # nospace | incompatible
            if cause is None:
                chosen, handle = self._dispatch_tokens(
                    [target], prompt, cont, f"{fl.rid}-d{fl.attempts}",
                    fl.deadline_s, slo_class=fl.slo_class,
                    tenant=fl.tenant)
                if chosen is None:
                    cause = "dispatch_failed"

        landing = "decode"
        if chosen is None:
            # Degrade: local decode on P (rung 2).  P may be draining or
            # mid-removal from the candidate set — dispatch to it directly
            # (draining replicas finish their own work, they just take no
            # NEW requests; a handoff fallback is this request's work).
            self._bump_handoff(cause or "error")
            local = next((c for c in ranked
                          if c.replica_id == prefill_id), None)
            if local is None and entry is not None:
                local = Candidate(prefill_id, entry.replica, entry.stats,
                                  entry.inflight)
            if local is not None:
                chosen, handle = self._dispatch_tokens(
                    [local], prompt, cont, f"{fl.rid}-l{fl.attempts}",
                    fl.deadline_s, slo_class=fl.slo_class,
                    tenant=fl.tenant)
            landing = "local"
        if chosen is None:
            # Rung 3: P is gone too — plain failover replay elsewhere.
            chosen, handle = self._dispatch_tokens(
                ranked, prompt, cont, f"{fl.rid}-f{fl.attempts}",
                fl.deadline_s, exclude={prefill_id},
                slo_class=fl.slo_class, tenant=fl.tenant)
            landing = "replay"
        if chosen is None:
            return (f"handoff failed ({cause or 'no target'}) and no "
                    "replica would take the continuation")
        self._bump_handoff(landing)
        get_tracer().record(
            "router.handoff", t0, time.monotonic(), fl.trace,
            status="ok" if landing == "decode" else "error",
            attrs={"request_id": fl.rid, "from": prefill_id,
                   "to": chosen, "landing": landing,
                   "cause": cause or "", "tokens": len(fl.emitted)})
        if landing != "decode":
            logger.info("handoff for %s degraded to %s on %s (%s)",
                        fl.rid, landing, chosen, cause)
        fl.prior = list(fl.emitted)
        fl.replica_id, fl.inner = chosen, handle
        fl.dispatch_t0 = time.monotonic()
        return None

    def _replica_browned_out(self, replica_id: str) -> bool:
        entry = self.registry.get(replica_id)
        return entry is not None and entry.stats.brownout >= 1

    def _maybe_hedge(self, fl: _Flight) -> Optional[RequestHandle]:
        """Wait the hedge delay for a first token; past it, race a second
        replica.  Returns the winning inner handle (the loser is cancelled)
        or None when no hedge happened.  Any token seen here is forwarded
        before returning, so ``_consume`` continues seamlessly."""
        delay = self.hedge_delay_s()
        primary = fl.inner
        try:
            tok = primary.poll_token(timeout=delay)
        except TimeoutError:
            tok = False  # no first token yet: hedge
        if tok is not False:
            if tok is not None:
                self._note_ttft(time.monotonic() - fl.dispatch_t0)
                fl.emitted.append(tok)
                fl.handle._push([tok], None)
            # else: stream ended inside the delay window (poll_token
            # re-armed the end sentinel for _consume).  Nothing to hedge.
            return None
        t_hedge = time.monotonic()
        ranked = self._ranked(fl.digest, need_tokens=True,
                              slo_class=fl.slo_class)
        chosen, hedge_handle = self._dispatch_tokens(
            ranked, fl.prompt_ids, fl.sampling, f"{fl.rid}-h",
            fl.deadline_s, exclude={fl.replica_id}, slo_class=fl.slo_class,
            tenant=fl.tenant)
        if chosen is None:
            return None
        self._bump("hedges_fired")
        winner_id, winner, loser_id, loser = self._race(
            fl.replica_id, primary, chosen, hedge_handle)
        if winner is hedge_handle:
            self._bump("hedges_won")
        get_tracer().record(
            "router.hedge", t_hedge, time.monotonic(), fl.trace,
            attrs={"request_id": fl.rid, "primary": fl.replica_id,
                   "hedge": chosen, "winner": winner_id,
                   "delay_s": round(delay, 6)})
        loser.cancel()
        # The loser keeps running to its (cancelled) completion on its own
        # replica; release the router-side inflight slot now.  Cancellation
        # is not a replica failure.
        self.registry.note_done(loser_id, ok=True)
        fl.replica_id, fl.inner = winner_id, winner
        return winner

    @staticmethod
    def _race(rid_a: str, ha: RequestHandle, rid_b: str, hb: RequestHandle):
        """First handle to show life (token or end-of-stream) wins.  A
        token seen here is NOT consumed — poll_token re-arms nothing for
        tokens, so peek by polling with a tiny timeout and pushing the
        token back is unsafe; instead the race polls with ``poll_token``
        and hands any consumed token straight back via the queue head."""
        while True:
            for rid, h in ((rid_a, ha), (rid_b, hb)):
                try:
                    tok = h.poll_token(timeout=0.005)
                except TimeoutError:
                    continue
                # Re-queue what we consumed so the winner's stream is
                # intact for _consume (FIFO queue: only safe because the
                # race is the sole consumer until it returns).
                if tok is not None:
                    h._tokens.queue.appendleft(tok)
                else:
                    pass  # poll_token already re-armed the end sentinel
                other_rid, other = (rid_b, hb) if h is ha else (rid_a, ha)
                return rid, h, other_rid, other

    def _fail(self, fl: _Flight, msg: str) -> None:
        self._bump("failed")
        self._settle_flight(fl)
        self._end_flight_span(fl, "error", error=msg[:200])
        fl.handle._replay_prefix = []
        fl.handle._push([], GenerationResult(
            request_id=fl.rid, token_ids=list(fl.emitted),
            finish_reason="error", ttft_s=0.0, latency_s=0.0, error=msg))

    def _finish_trimmed(self, fl: _Flight) -> None:
        """The dying replica had already emitted the full budget: complete
        with what was streamed (nothing left to regenerate)."""
        self._settle_flight(fl)
        self._end_flight_span(fl, "ok", finish_reason="length")
        fl.handle._replay_prefix = []
        fl.handle._push([], GenerationResult(
            request_id=fl.rid, token_ids=list(fl.emitted),
            finish_reason="length", ttft_s=0.0, latency_s=0.0))
        self._bump("completed")

    # -- text-level routing (HTTP replicas) ------------------------------

    def _dispatch_text(self, digest: bytes, op,
                       slo_class: str = "standard"):
        """Run ``op(replica)`` on the first candidate that takes it;
        connection-level failures fall through to the next candidate."""
        ranked = self._ranked(digest, need_tokens=False,
                              slo_class=slo_class)
        last_exc: Exception | None = None
        for cand in ranked:
            entry = self.registry.get(cand.replica_id)
            if entry is None:
                continue
            try:
                entry.breaker.before_call()
            except CircuitOpen as exc:
                last_exc = exc
                continue
            self.registry.note_dispatch(cand.replica_id)
            self._bump("dispatches")
            try:
                out = op(cand.replica)
            except OverloadedError as exc:
                entry.breaker.record_success()
                self.registry.note_done(cand.replica_id, ok=True)
                last_exc = exc
                continue
            except Exception as exc:  # noqa: BLE001 — routing fact
                self.registry.note_done(cand.replica_id, ok=False)
                self.registry.mark_unready(cand.replica_id, str(exc))
                last_exc = exc
                continue
            self._account_affinity(digest, cand.replica_id, ranked)
            return cand.replica_id, out
        self._bump("sheds")
        if isinstance(last_exc, OverloadedError):
            raise last_exc
        raise OverloadedError(
            f"no replica available ({last_exc or 'fleet empty'})",
            retriable=True, retry_after_s=1.0, slo_class=slo_class)

    def _admit_text(self, tenant: str, slo_class: str) -> None:
        """Rate-only quota for the text paths: there is no token budget to
        reserve up front (the replica owns generation), so charge one
        request-bucket token and settle the empty reservation at once.
        Raises the tenant-tagged 429 before any replica is contacted."""
        if self.governor is None:
            return
        rid = f"fleet-q-{next(self._ids)}"
        self.governor.admit(tenant, rid, max_tokens=0, slo_class=slo_class)
        self.governor.settle(rid)

    def query(self, question: str,
              slo_class: str = "interactive",
              tenant: str = DEFAULT_TENANT) -> dict:
        tenant = normalize_tenant(tenant)
        self._admit_text(tenant, slo_class)
        rid, payload = self._dispatch_text(
            self._text_digest(question),
            lambda r: r.query(question, slo_class=slo_class,
                              tenant=tenant),
            slo_class=slo_class)
        self.registry.note_done(rid, ok=True)
        return payload

    def analyze(self, payload: dict,
                tenant: str = DEFAULT_TENANT) -> dict:
        tenant = normalize_tenant(tenant)
        self._admit_text(tenant, "standard")
        rid, out = self._dispatch_text(
            self._text_digest(payload.get("type", "")),
            lambda r: r.analyze(payload, tenant=tenant))
        self.registry.note_done(rid, ok=True)
        return out

    def diagnoses(self, limit: int = 0) -> dict:
        """Verdict history from any one replica's standing pipeline.  A
        fixed digest keeps consecutive polls on the same replica (histories
        are per-replica rings, so a stable view beats a merged one)."""
        rid, out = self._dispatch_text(
            self._text_digest("diagnoses"), lambda r: r.diagnoses(limit))
        self.registry.note_done(rid, ok=True)
        if isinstance(out, dict):
            out = dict(out)
            out["replica"] = rid
        return out

    def query_stream(self, question: str, slo_class: str = "interactive",
                     tenant: str = DEFAULT_TENANT):
        """Returns (request_id, model, delta iterator).  The iterator fails
        over mid-stream: a new replica re-answers and the already-delivered
        character prefix is suppressed, so the caller sees a contiguous
        stream (exact for deterministic backends — greedy decode over the
        same evidence; the token-level path is the strict contract).
        Failover re-dispatches ride the original admission — the quota
        charge happens once, here."""
        tenant = normalize_tenant(tenant)
        self._admit_text(tenant, slo_class)
        digest = self._text_digest(question)
        rid, (rep_rid, model, chunks) = self._dispatch_text(
            digest, lambda r: r.query_stream(question, slo_class=slo_class,
                                             tenant=tenant),
            slo_class=slo_class)

        def deltas():
            nonlocal rid, chunks
            emitted = 0
            skip = 0
            attempts = 0
            while True:
                try:
                    for delta in chunks:
                        if skip:
                            take = delta[skip:]
                            skip = max(0, skip - len(delta))
                            delta = take
                        if delta:
                            emitted += len(delta)
                            yield delta
                    self.registry.note_done(rid, ok=True)
                    self._bump("completed")
                    return
                except GeneratorExit:
                    if hasattr(chunks, "close"):
                        chunks.close()
                    self.registry.note_done(rid, ok=True)
                    raise
                except Exception as exc:  # noqa: BLE001 — failover trigger
                    self.registry.note_done(rid, ok=False)
                    self.registry.mark_unready(rid, str(exc))
                    self._bump("failovers")
                    attempts += 1
                    if attempts > self.max_failovers:
                        self._bump("failed")
                        raise
                    try:
                        rid, (_, _, chunks) = self._dispatch_text(
                            digest,
                            lambda r: r.query_stream(question,
                                                     slo_class=slo_class,
                                                     tenant=tenant),
                            slo_class=slo_class)
                    except OverloadedError:
                        self._bump("failed")
                        raise exc from None
                    skip = emitted
                    logger.info("stream %s failed over mid-answer after "
                                "%d chars", rep_rid, emitted)

        return rep_rid, model, deltas()
