"""Jittered exponential backoff with a retry budget + a circuit breaker.

One retry discipline for every remote dependency: ``KubeRestBackend``
requests retry through :class:`Backoff`, the watcher reconnect loops reuse
the same curve (replacing their fixed 5 s sleeps), and a shared
:class:`CircuitBreaker` stops a 5xx storm from turning every poll thread
into a retry hammer against a struggling apiserver.

Determinism: both classes take an injectable ``clock`` / ``rng`` so chaos
tests replay identically and never sleep real wall-clock time.
"""

from __future__ import annotations

import random
import time

from k8s_llm_monitor_tpu_torch.devtools.lockcheck import guarded_by, make_lock


class Backoff:
    """Jittered exponential delay schedule with a bounded attempt budget.

    ``delays()`` yields ``base * mult^i`` capped at ``cap``, each scaled by
    a uniform jitter in [1-jitter, 1+jitter] — full determinism comes from
    the injected ``rng``.  ``attempts`` counts the *total* tries (first try
    + retries), so ``attempts=3`` means at most 2 delays.
    """

    def __init__(self, base_s: float = 0.2, cap_s: float = 30.0,
                 mult: float = 2.0, jitter: float = 0.2,
                 attempts: int = 4, rng: random.Random | None = None):
        if attempts < 1:
            raise ValueError("attempts must be >= 1")
        self.base_s = base_s
        self.cap_s = cap_s
        self.mult = mult
        self.jitter = jitter
        self.attempts = attempts
        self._rng = rng or random.Random()

    def delay(self, retry_index: int) -> float:
        """Delay before retry ``retry_index`` (0-based)."""
        raw = min(self.base_s * (self.mult ** retry_index), self.cap_s)
        if self.jitter > 0:
            raw *= 1.0 + self._rng.uniform(-self.jitter, self.jitter)
        return max(raw, 0.0)

    def delays(self):
        """The (attempts - 1) inter-try delays, in order."""
        for i in range(self.attempts - 1):
            yield self.delay(i)


class CircuitOpen(Exception):
    """Raised when a call is refused because the breaker is open."""

    def __init__(self, remaining_s: float):
        super().__init__(
            f"circuit open ({remaining_s:.1f}s until half-open probe)")
        self.remaining_s = remaining_s


@guarded_by("_lock", "_consecutive", "_opened_at", "_probing",
            "trips", "rejections")
class CircuitBreaker:
    """Consecutive-failure breaker with a half-open probe.

    closed  → normal operation; ``failure_threshold`` consecutive failures
              trip it open.
    open    → calls raise :class:`CircuitOpen` for ``cooldown_s``.
    half-open → after cooldown ONE probe call is let through; success
              closes the breaker, failure re-opens it for another cooldown.

    Thread-safe: poll threads, watch threads and HTTP handlers share one
    breaker per backend.
    """

    def __init__(self, failure_threshold: int = 5, cooldown_s: float = 10.0,
                 clock=time.monotonic):
        self.failure_threshold = failure_threshold
        self.cooldown_s = cooldown_s
        self._clock = clock
        self._consecutive = 0
        self._opened_at: float | None = None
        self._probing = False
        self.trips = 0           # times the breaker opened
        self.rejections = 0      # calls refused while open
        # Created last: lockcheck's guarded_by treats writes before the
        # lock exists as construction, not races.
        self._lock = make_lock("resilience.breaker")

    @property
    def state(self) -> str:
        with self._lock:
            return self._state_locked()

    def _state_locked(self) -> str:
        if self._opened_at is None:
            return "closed"
        if self._clock() - self._opened_at >= self.cooldown_s:
            return "half-open"
        return "open"

    def before_call(self) -> None:
        """Gate a call: raises :class:`CircuitOpen` when refusing. In the
        half-open state exactly one caller wins the probe slot; the rest
        are refused until the probe resolves."""
        with self._lock:
            st = self._state_locked()
            if st == "closed":
                return
            if st == "half-open" and not self._probing:
                self._probing = True
                return
            self.rejections += 1
            remaining = 0.0
            if self._opened_at is not None:
                remaining = max(
                    0.0, self.cooldown_s - (self._clock() - self._opened_at))
            raise CircuitOpen(remaining)

    def record_success(self) -> None:
        with self._lock:
            self._consecutive = 0
            self._opened_at = None
            self._probing = False

    def record_failure(self) -> None:
        with self._lock:
            self._consecutive += 1
            if self._probing:
                # Failed probe: re-open for a fresh cooldown.
                self._probing = False
                self._opened_at = self._clock()
                self.trips += 1
            elif (self._opened_at is None
                    and self._consecutive >= self.failure_threshold):
                self._opened_at = self._clock()
                self.trips += 1
