"""Process-global fault injector with named failure points.

Real v5e-8 failures (a wedged dispatch, a KV pool exhausted by a burst, an
apiserver 5xx storm) cannot be provoked on demand, so every layer plants a
*named hook* here and chaos tests (tests/test_resilience.py) arm the hook
instead of waiting for hardware to misbehave.  Production builds pay one
dict lookup + one ``is-armed`` check per hook when nothing is armed.

Configuration:

  * env — ``K8SLLM_FAULTS=decode_dispatch:0.05,kube_http_5xx:0.3`` arms
    points at the given firing probability for the whole process;
  * programmatic — ``get_injector().arm("decode_dispatch", rate=1.0,
    times=3)`` (tests; ``times`` bounds total firings, ``after`` skips the
    first N evaluations so a fault can land mid-stream).

Determinism: the injector draws from its own seeded ``random.Random`` so a
chaos run replays identically; re-seed with ``reset(seed=...)``.
"""

from __future__ import annotations

import os
import random
from dataclasses import dataclass

from k8s_llm_monitor_tpu_torch.devtools.lockcheck import make_lock

# The registry of failure points layers may hook.  Hooks for unknown names
# raise immediately — a typo'd point name must fail the test that armed it,
# not silently never fire.
FAULT_POINTS: frozenset[str] = frozenset({
    # serving/engine.py — dispatch paths
    "decode_dispatch",      # fused/spec decode program call raises
    "prefill_dispatch",     # batched prefill / chunk-round program call raises
    "decode_stuck",         # decode result never becomes ready (watchdog food)
    "slow_host_callback",   # reconcile-side host work sleeps delay_s
    "lane_eviction",        # class-ordered preemption raises mid-eviction
    # serving/kv_cache.py — allocator
    "alloc_exhaustion",     # alloc/extend raise OutOfBlocks despite free pages
    # serving/service.py — step loop
    "step_loop_crash",      # step loop raises mid-iteration (supervisor food)
    # monitor/kube_rest.py — apiserver client
    "kube_http_5xx",        # _request sees a synthetic 503
    "kube_http_timeout",    # _request sees a synthetic socket timeout
    "kube_http_reset",      # _request sees a synthetic connection reset
})


class FaultError(RuntimeError):
    """Raised by an armed failure point (engine dispatch hooks)."""

    def __init__(self, point: str):
        super().__init__(f"injected fault: {point}")
        self.point = point


@dataclass
class _Point:
    rate: float = 0.0        # firing probability per evaluation
    times: int = -1          # firings remaining; -1 = unbounded
    after: int = 0           # evaluations to skip before arming takes effect
    delay_s: float = 0.0     # for slow_* points: how long to stall
    evaluations: int = 0
    fired: int = 0


class FaultInjector:
    """Named-failure-point registry.  Thread-safe; cheap when disarmed."""

    def __init__(self, seed: int = 0):
        self._lock = make_lock("faults.injector")
        self._rng = random.Random(seed)
        self._points: dict[str, _Point] = {}
        self._load_env()

    # -- configuration --------------------------------------------------

    def _load_env(self) -> None:
        spec = os.environ.get("K8SLLM_FAULTS", "")
        if not spec:
            return
        for part in spec.split(","):
            part = part.strip()
            if not part:
                continue
            name, _, rate = part.partition(":")
            try:
                self.arm(name.strip(), rate=float(rate) if rate else 1.0)
            except ValueError:
                # A malformed env spec must be loud: silently ignoring it
                # would make a chaos drill a no-op.
                raise ValueError(
                    f"K8SLLM_FAULTS: bad entry {part!r} "
                    f"(want point:rate)") from None

    def arm(self, point: str, rate: float = 1.0, times: int = -1,
            after: int = 0, delay_s: float = 0.0) -> None:
        """Arm ``point`` to fire with probability ``rate`` per evaluation,
        at most ``times`` total firings (-1 = unbounded), skipping the
        first ``after`` evaluations."""
        if point not in FAULT_POINTS:
            raise ValueError(f"unknown fault point {point!r} "
                             f"(known: {sorted(FAULT_POINTS)})")
        with self._lock:
            self._points[point] = _Point(
                rate=rate, times=times, after=after, delay_s=delay_s)

    def disarm(self, point: str) -> None:
        with self._lock:
            self._points.pop(point, None)

    def reset(self, seed: int = 0) -> None:
        """Disarm everything and re-seed (test isolation)."""
        with self._lock:
            self._points.clear()
            self._rng = random.Random(seed)

    # -- evaluation (the planted hooks call these) ----------------------

    def should_fire(self, point: str) -> bool:
        """One evaluation of ``point``: True when the fault fires now."""
        with self._lock:
            p = self._points.get(point)
            if p is None:
                return False
            p.evaluations += 1
            if p.evaluations <= p.after:
                return False
            if p.times == 0:
                return False
            if p.rate < 1.0 and self._rng.random() >= p.rate:
                return False
            p.fired += 1
            if p.times > 0:
                p.times -= 1
            return True

    def maybe_raise(self, point: str) -> None:
        """Raise :class:`FaultError` when ``point`` fires (dispatch hooks)."""
        if self.should_fire(point):
            raise FaultError(point)

    def delay_s(self, point: str) -> float:
        """Armed stall duration for slow_* points (0.0 = fire-and-forget)."""
        with self._lock:
            p = self._points.get(point)
            return p.delay_s if p is not None else 0.0

    def fired(self, point: str) -> int:
        with self._lock:
            p = self._points.get(point)
            return p.fired if p is not None else 0

    @property
    def armed(self) -> dict[str, float]:
        with self._lock:
            return {k: v.rate for k, v in self._points.items()}


_injector: FaultInjector | None = None
_injector_lock = make_lock("faults.global_init")


def get_injector() -> FaultInjector:
    """The process-global injector (env-configured on first use)."""
    global _injector
    if _injector is None:
        with _injector_lock:
            if _injector is None:
                _injector = FaultInjector()
    return _injector
