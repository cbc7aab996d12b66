"""Lock-discipline / race detector (the ``K8SLLM_LOCKCHECK=1`` mode).

The engine loop, watchdog, request threads, metrics-manager loop, and
watcher reconnect threads share state behind a dozen locks; pytest cannot
see a lock-order inversion or an unlocked write — it only sees the rare
deadlock or corruption those bugs eventually cause.  This module is the
Python stand-in for the Go race detector the reference repo relied on
(PAPER.md §L4):

  * every lock in the serving/monitor/resilience planes is created through
    :func:`make_lock`, which returns a plain ``threading.Lock``/``RLock``
    in production (zero overhead) and an :class:`InstrumentedLock` when
    ``K8SLLM_LOCKCHECK=1``;
  * instrumented locks record, per acquisition, the set of locks the
    acquiring thread already holds — building a global lock-order graph
    whose cycles are *potential deadlocks* even if no run ever deadlocked;
  * holds longer than ``K8SLLM_LOCKCHECK_HOLD_MS`` (default 200) are
    flagged — a slow call under the engine-service handles lock stalls
    every request thread;
  * classes decorated with :func:`guarded_by` assert that writes to their
    registered shared fields happen with the owning lock held.

``report()`` aggregates everything; the chaos suite runs under this mode
and tests/conftest.py fails the session on a dirty report.

Import discipline: stdlib only.  resilience/faults.py imports this module
at interpreter startup; it must never pull in torch, numpy, or the lint.
"""

from __future__ import annotations

import os
import threading
import time
from dataclasses import dataclass, field

ENV_FLAG = "K8SLLM_LOCKCHECK"
ENV_HOLD_MS = "K8SLLM_LOCKCHECK_HOLD_MS"
_FALSE = ("", "0", "false", "no", "off")


def enabled() -> bool:
    """True when the instrumented-lock mode is armed (checked at lock
    *creation* time — set the env var before constructing the objects
    under test)."""
    return os.environ.get(ENV_FLAG, "").lower() not in _FALSE


def hold_warn_ms() -> float:
    try:
        return float(os.environ.get(ENV_HOLD_MS, "200"))
    except ValueError:
        return 200.0


# Per-thread stack of InstrumentedLock names currently held, outermost
# first.  RLock re-entries do not push a second frame.
_held = threading.local()


def _held_stack() -> list[str]:
    stack = getattr(_held, "stack", None)
    if stack is None:
        stack = []
        _held.stack = stack
    return stack


@dataclass
class LongHold:
    lock: str
    held_ms: float
    thread: str


@dataclass
class UnguardedWrite:
    cls: str
    attr: str
    lock: str
    thread: str


@dataclass
class Registry:
    """Global evidence store for one lockcheck run.

    ``edges`` is the lock-order graph: ``(a, b)`` means some thread
    acquired ``b`` while holding ``a``.  A cycle in this graph is a
    potential deadlock regardless of whether any run has interleaved badly
    enough to hit it.
    """

    edges: dict[tuple[str, str], int] = field(default_factory=dict)
    locks: set[str] = field(default_factory=set)
    long_holds: list[LongHold] = field(default_factory=list)
    unguarded_writes: list[UnguardedWrite] = field(default_factory=list)
    acquisitions: dict[str, int] = field(default_factory=dict)
    max_hold_ms: dict[str, float] = field(default_factory=dict)
    _mu: threading.Lock = field(default_factory=threading.Lock)

    # -- recording (called by InstrumentedLock / guarded_by) ------------

    def note_acquire(self, name: str, held: list[str]) -> None:
        with self._mu:
            self.locks.add(name)
            self.acquisitions[name] = self.acquisitions.get(name, 0) + 1
            for h in held:
                if h != name:
                    self.edges[(h, name)] = self.edges.get((h, name), 0) + 1

    def note_release(self, name: str, held_ms: float) -> None:
        with self._mu:
            if held_ms > self.max_hold_ms.get(name, 0.0):
                self.max_hold_ms[name] = held_ms
            if held_ms > hold_warn_ms():
                self.long_holds.append(LongHold(
                    lock=name, held_ms=round(held_ms, 3),
                    thread=threading.current_thread().name))

    def note_unguarded(self, cls: str, attr: str, lock: str) -> None:
        with self._mu:
            self.unguarded_writes.append(UnguardedWrite(
                cls=cls, attr=attr, lock=lock,
                thread=threading.current_thread().name))

    # -- analysis -------------------------------------------------------

    def cycles(self) -> list[list[str]]:
        """Elementary cycles in the lock-order graph (DFS; the graph has
        tens of nodes at most, so no Johnson's needed)."""
        with self._mu:
            adj: dict[str, set[str]] = {}
            for a, b in self.edges:
                adj.setdefault(a, set()).add(b)
        out: list[list[str]] = []
        seen_cycles: set[tuple[str, ...]] = set()

        def dfs(start: str, node: str, path: list[str],
                on_path: set[str]) -> None:
            for nxt in sorted(adj.get(node, ())):
                if nxt == start:
                    # Canonicalize by rotating the smallest name first so
                    # the same cycle found from two starts dedups.
                    cyc = path[:]
                    k = cyc.index(min(cyc))
                    canon = tuple(cyc[k:] + cyc[:k])
                    if canon not in seen_cycles:
                        seen_cycles.add(canon)
                        out.append(list(canon))
                elif nxt not in on_path and nxt > start:
                    # Only explore nodes > start: each cycle is found from
                    # its smallest member exactly once.
                    on_path.add(nxt)
                    dfs(start, nxt, path + [nxt], on_path)
                    on_path.discard(nxt)

        for start in sorted(adj):
            dfs(start, start, [start], {start})
        return out

    def report(self) -> dict:
        cycles = self.cycles()
        with self._mu:
            return {
                "enabled": enabled(),
                "locks": sorted(self.locks),
                "acquisitions": dict(sorted(self.acquisitions.items())),
                "order_edges": sorted(
                    f"{a} -> {b}" for (a, b) in self.edges),
                "cycles": cycles,
                "long_holds": [vars(h) for h in self.long_holds],
                "max_hold_ms": {k: round(v, 3) for k, v in
                                sorted(self.max_hold_ms.items())},
                "unguarded_writes": [vars(w) for w in self.unguarded_writes],
                "ok": not cycles and not self.unguarded_writes,
            }

    def assert_clean(self) -> None:
        rep = self.report()
        problems = []
        if rep["cycles"]:
            problems.append(f"lock-order cycles: {rep['cycles']}")
        if rep["unguarded_writes"]:
            problems.append(
                f"unguarded shared-state writes: {rep['unguarded_writes']}")
        if problems:
            raise AssertionError("lockcheck: " + "; ".join(problems))

    def reset(self) -> None:
        with self._mu:
            self.edges.clear()
            self.locks.clear()
            self.long_holds.clear()
            self.unguarded_writes.clear()
            self.acquisitions.clear()
            self.max_hold_ms.clear()


_registry = Registry()


def registry() -> Registry:
    return _registry


class InstrumentedLock:
    """Drop-in for ``threading.Lock``/``RLock`` that feeds the registry.

    Tracks the owning thread (so :func:`guarded_by` can ask ``held_by_me``
    even for non-reentrant locks) and the re-entry depth (so an RLock
    re-entry records neither a new order edge nor a nested hold span).
    """

    def __init__(self, name: str, reentrant: bool = False,
                 reg: Registry | None = None):
        self.name = name
        self._reentrant = reentrant
        self._inner = threading.RLock() if reentrant else threading.Lock()
        self._reg = reg or _registry
        self._owner: int | None = None
        self._depth = 0
        self._t0 = 0.0

    @property
    def held_by_me(self) -> bool:
        return self._owner == threading.get_ident()

    def locked(self) -> bool:
        return self._owner is not None

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        me = threading.get_ident()
        if self._reentrant and self._owner == me:
            self._inner.acquire()
            self._depth += 1
            return True
        self._reg.note_acquire(self.name, _held_stack())
        ok = self._inner.acquire(blocking, timeout)
        if ok:
            self._owner = me
            self._depth = 1
            self._t0 = time.monotonic()
            _held_stack().append(self.name)
        return ok

    def release(self) -> None:
        if self._owner != threading.get_ident():
            raise RuntimeError(
                f"lock {self.name!r} released by non-owner thread")
        self._depth -= 1
        if self._depth == 0:
            held_ms = (time.monotonic() - self._t0) * 1e3
            self._owner = None
            stack = _held_stack()
            if self.name in stack:
                stack.remove(self.name)
            self._reg.note_release(self.name, held_ms)
        self._inner.release()

    def __enter__(self) -> "InstrumentedLock":
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()


def make_lock(name: str, reentrant: bool = False):
    """The one lock factory for the serving/monitor/resilience planes.

    Production (env flag unset): a plain ``threading.Lock`` / ``RLock`` —
    identical cost to constructing one directly.  ``K8SLLM_LOCKCHECK=1``:
    an :class:`InstrumentedLock` wired into the global registry."""
    if enabled():
        return InstrumentedLock(name, reentrant=reentrant)
    return threading.RLock() if reentrant else threading.Lock()


def guarded_by(lock_attr: str, *fields: str):
    """Class decorator registering shared fields owned by ``lock_attr``.

    With lockcheck enabled, every ``self.<field> = ...`` outside the
    owning lock is recorded as an unguarded write (writes before the lock
    exists — i.e. during ``__init__`` — are exempt, as is any setup done
    while the lock is a plain non-instrumented lock).  Disabled: returns
    the class untouched, so production pays nothing.
    """

    def deco(cls):
        if not enabled():
            return cls
        watched = frozenset(fields)
        orig_setattr = cls.__setattr__

        def checked_setattr(self, name, value):
            if name in watched:
                lock = getattr(self, lock_attr, None)
                if (isinstance(lock, InstrumentedLock)
                        and not lock.held_by_me):
                    _registry.note_unguarded(
                        cls.__name__, name, lock.name)
            orig_setattr(self, name, value)

        cls.__setattr__ = checked_setattr
        return cls

    return deco
