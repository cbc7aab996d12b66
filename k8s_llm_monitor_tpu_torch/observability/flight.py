"""Crash flight recorder (docs/observability.md).

A bounded in-memory event log (engine/service/supervisor milestones:
watchdog trips, shed decisions, preemptions, rebuilds) that, together
with the tracer's span ring, is dumped to a JSON artifact when the
process hits a failure edge: watchdog fire (``_reset_pipeline``),
``EngineService._fail_all``, a supervisor rebuild, or SIGTERM.  Every
crash gets a postmortem timeline alongside the WAL.

``note()`` is a single deque.append (GIL-atomic, lock-free, O(1));
``dump()`` does file I/O but only on failure edges, never on a hot
path, and swallows OSErrors — a full disk must not turn a recoverable
fault into a crash.
"""

from __future__ import annotations

import collections
import itertools
import json
import os
import re
import tempfile
import time
from typing import Any, Callable, Optional

from .tracing import get_tracer

__all__ = ["FlightRecorder", "get_flight_recorder"]

_REASON_RE = re.compile(r"[^A-Za-z0-9_.-]+")


def _default_dir() -> str:
    return (os.environ.get("K8SLLM_FLIGHT_DIR")
            or os.path.join(tempfile.gettempdir(), "k8sllm-flight"))


class FlightRecorder:
    """Bounded event ring + JSON dump-on-failure.  Artifact format
    (version 2): ``{"version", "reason", "ts_unix", "pid", "events":
    [{"t_unix", "t_mono", "kind", ...}], "spans": [span dicts],
    "signals": {...} | null, "extra": {...}}``.

    ``signal_source`` is an optional zero-arg callable returning a
    JSON-safe snapshot of the local telemetry window (wired to
    ``TimeSeriesStore.window_snapshot`` by the server builders) — the
    load trajectory *into* the crash, alongside the event/span timeline.
    A raising source never fails the dump."""

    def __init__(self, capacity: int = 512,
                 dirpath: Optional[str] = None) -> None:
        self._events: collections.deque[dict] = collections.deque(
            maxlen=max(16, int(capacity)))
        self._dir = dirpath or _default_dir()
        self._seq = itertools.count()
        self.dumps = 0
        self.dump_errors = 0
        self.last_dump_path = ""
        self.signal_source: Optional[Callable[[], Any]] = None

    def note(self, kind: str, **fields: Any) -> None:
        """Record one engine/service event (lock-free, bounded)."""
        ev = {"t_unix": time.time(), "t_mono": time.monotonic(),
              "kind": kind}
        ev.update(fields)
        self._events.append(ev)

    def events(self) -> list[dict]:
        return list(self._events)

    def dump(self, reason: str, extra: Optional[dict] = None) -> str:
        """Write the artifact; returns its path ("" on I/O failure)."""
        safe = _REASON_RE.sub("_", reason)[:64] or "unknown"
        signals = None
        if self.signal_source is not None:
            try:
                signals = self.signal_source()
            except Exception:  # noqa: BLE001 — snapshot is best-effort
                signals = {"error": "signal snapshot failed"}
        payload = {
            "version": 2,
            "reason": reason,
            "ts_unix": time.time(),
            "pid": os.getpid(),
            "events": self.events(),
            "spans": get_tracer().snapshot(),
            "signals": signals,
            "extra": extra or {},
        }
        try:
            os.makedirs(self._dir, exist_ok=True)
            path = os.path.join(
                self._dir,
                f"flight-{safe}-{os.getpid()}-{next(self._seq)}.json")
            tmp = path + ".tmp"
            with open(tmp, "w", encoding="utf-8") as f:
                json.dump(payload, f, default=str)
            os.replace(tmp, path)
        except OSError:
            self.dump_errors += 1
            return ""
        self.dumps += 1
        self.last_dump_path = path
        return path


_RECORDER: Optional[FlightRecorder] = None


def get_flight_recorder() -> FlightRecorder:
    """The per-process flight recorder singleton."""
    global _RECORDER
    if _RECORDER is None:
        _RECORDER = FlightRecorder()
    return _RECORDER


def set_flight_recorder(rec: Optional[FlightRecorder]) -> None:
    """Swap the process recorder (tests)."""
    global _RECORDER
    _RECORDER = rec
