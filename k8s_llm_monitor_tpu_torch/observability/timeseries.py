"""Bounded in-process time-series store (docs/observability.md).

The telemetry plane's storage layer: a dict of fixed-capacity rings of
``(t, value)`` points keyed by ``(name, sorted-label-items)``.  Zero
dependencies, one lock, O(capacity) memory per series with a hard cap on
the number of series — the store can run inside every replica and the
router forever without growing.

Semantics the query layer is built on:

  * **NaN is a marker, not garbage.**  Scrapers record an explicit NaN
    when a signal exists but has no measurement (the exposition
    rule: absent labels silently mix populations; NaN says "not measured
    *here*, *now*").  ``last()`` returns the newest raw point — NaN
    passes through, so staleness markers survive the query layer —
    while the windowed math (``rate``/``delta``/``ema``/``quantile``)
    skips non-finite points.
  * **Deterministic under a fake clock.**  Both ``record()`` and the
    window queries take the time axis from the injectable ``clock``
    (overridable per call via ``t=``/``now=``), so tests drive the
    exact same point sequence to the exact same answers.
"""

from __future__ import annotations

import math
import time
from collections import deque
from typing import Callable, Iterable, Optional

from k8s_llm_monitor_tpu_torch.devtools.lockcheck import guarded_by, make_lock

__all__ = ["TimeSeriesStore"]

LabelItems = tuple[tuple[str, str], ...]
SeriesKey = tuple[str, LabelItems]


def _label_items(labels: Optional[dict]) -> LabelItems:
    return tuple(sorted((str(k), str(v)) for k, v in (labels or {}).items()))


def _finite(points: Iterable[tuple[float, float]]) -> list[tuple[float, float]]:
    return [(t, v) for t, v in points if math.isfinite(v)]


@guarded_by("_lock", "_series", "points_total", "dropped_series_total")
class TimeSeriesStore:
    """Fixed-capacity ring buffer per ``(name, labels)`` series.

    ``capacity`` bounds points per series; ``max_series`` bounds the
    label-cardinality blast radius — a scraper bug that mints unbounded
    label values drops new series (counted) instead of eating the heap.
    """

    def __init__(self, capacity: int = 512, max_series: int = 2048,
                 clock: Callable[[], float] = time.monotonic) -> None:
        self.capacity = max(2, int(capacity))
        self.max_series = max(1, int(max_series))
        self._clock = clock
        self.points_total = 0
        self.dropped_series_total = 0
        self._series: dict[SeriesKey, deque[tuple[float, float]]] = {}
        # Created last (lockcheck: __init__ writes are construction).
        self._lock = make_lock("observability.timeseries")

    # -- writing ---------------------------------------------------------

    def record(self, name: str, value: float,
               labels: Optional[dict] = None,
               t: Optional[float] = None) -> None:
        """Append one point.  ``value`` may be NaN (explicit "unmeasured"
        marker); ``t`` defaults to the store clock.  Never raises on a
        bad value — a telemetry write must not take down its caller."""
        try:
            v = float(value)
        except (TypeError, ValueError):
            v = float("nan")
        key = (str(name), _label_items(labels))
        stamp = self._clock() if t is None else float(t)
        with self._lock:
            ring = self._series.get(key)
            if ring is None:
                if len(self._series) >= self.max_series:
                    self.dropped_series_total += 1
                    return
                ring = deque(maxlen=self.capacity)
                self._series[key] = ring
            ring.append((stamp, v))
            self.points_total += 1

    def evict(self, labels: dict) -> int:
        """Drop every series whose labels contain ``labels`` as a subset;
        returns the number of series removed.  Fleet-membership GC: when a
        replica leaves, its ``{replica=...}`` series must not linger as
        permanently-stale signal targets (or crowd new replicas out of the
        ``max_series`` cap)."""
        want = _label_items(labels)
        if not want:
            return 0
        with self._lock:
            doomed = [key for key in self._series
                      if set(want) <= set(key[1])]
            for key in doomed:
                del self._series[key]
        return len(doomed)

    # -- reading ---------------------------------------------------------

    def series_count(self) -> int:
        with self._lock:
            return len(self._series)

    def totals(self) -> dict:
        """Store self-accounting for the exporter: live series, points
        ever recorded, series refused at the cardinality cap."""
        with self._lock:
            return {
                "series": len(self._series),
                "points_total": self.points_total,
                "dropped_series_total": self.dropped_series_total,
            }

    def names(self) -> list[str]:
        with self._lock:
            return sorted({name for name, _ in self._series})

    def keys(self, name: Optional[str] = None) -> list[SeriesKey]:
        with self._lock:
            return sorted(k for k in self._series
                          if name is None or k[0] == name)

    def points(self, name: str, labels: Optional[dict] = None,
               window_s: Optional[float] = None,
               now: Optional[float] = None) -> list[tuple[float, float]]:
        """Chronological points of one exact series, optionally clipped
        to the trailing ``window_s``.  Empty list when the series does
        not exist — queries turn that into NaN, not an error."""
        key = (str(name), _label_items(labels))
        with self._lock:
            ring = self._series.get(key)
            pts = list(ring) if ring is not None else []
        if window_s is not None and pts:
            anchor = (self._clock() if now is None else now) - float(window_s)
            pts = [(t, v) for t, v in pts if t >= anchor]
        return pts

    def last(self, name: str, labels: Optional[dict] = None,
             window_s: Optional[float] = None,
             now: Optional[float] = None) -> float:
        """Newest raw value in the window (NaN markers pass through);
        NaN when the series is absent or the window is empty."""
        pts = self.points(name, labels, window_s, now)
        return pts[-1][1] if pts else float("nan")

    def delta(self, name: str, labels: Optional[dict] = None,
              window_s: Optional[float] = None,
              now: Optional[float] = None) -> float:
        """last - first over the finite points in the window; NaN with
        fewer than two finite points."""
        pts = _finite(self.points(name, labels, window_s, now))
        if len(pts) < 2:
            return float("nan")
        return pts[-1][1] - pts[0][1]

    def rate(self, name: str, labels: Optional[dict] = None,
             window_s: Optional[float] = None,
             now: Optional[float] = None) -> float:
        """(last - first) / (t_last - t_first) over the finite points in
        the window — per-second growth; NaN with fewer than two finite
        points or a zero time span."""
        pts = _finite(self.points(name, labels, window_s, now))
        if len(pts) < 2:
            return float("nan")
        dt = pts[-1][0] - pts[0][0]
        if dt <= 0.0:
            return float("nan")
        return (pts[-1][1] - pts[0][1]) / dt

    def ema(self, name: str, labels: Optional[dict] = None,
            window_s: Optional[float] = None,
            half_life_s: float = 10.0,
            now: Optional[float] = None) -> float:
        """Irregular-interval exponential moving average over the finite
        points in the window: each step decays the running value by
        ``0.5 ** (dt / half_life_s)``.  Deterministic — same points, same
        answer.  NaN when no finite point is in the window."""
        pts = _finite(self.points(name, labels, window_s, now))
        if not pts:
            return float("nan")
        hl = max(1e-9, float(half_life_s))
        value = pts[0][1]
        for (t_prev, _), (t_cur, v) in zip(pts, pts[1:]):
            w = 0.5 ** (max(0.0, t_cur - t_prev) / hl)
            value = w * value + (1.0 - w) * v
        return value

    def quantile(self, name: str, q: float,
                 labels: Optional[dict] = None,
                 window_s: Optional[float] = None,
                 now: Optional[float] = None) -> float:
        """Linear-interpolated quantile (q in [0, 1]; p50 = 0.5, p99 =
        0.99) of the finite values in the window; NaN when empty."""
        vals = sorted(v for _, v in _finite(
            self.points(name, labels, window_s, now)))
        if not vals:
            return float("nan")
        qq = min(1.0, max(0.0, float(q)))
        pos = qq * (len(vals) - 1)
        lo = int(math.floor(pos))
        hi = int(math.ceil(pos))
        if lo == hi:
            return vals[lo]
        frac = pos - lo
        return vals[lo] * (1.0 - frac) + vals[hi] * frac

    # -- export ----------------------------------------------------------

    def export(self, name: str, window_s: Optional[float] = None,
               label_filter: Optional[dict] = None) -> list[dict]:
        """JSON-safe dump of every series under ``name`` whose labels
        contain ``label_filter`` as a subset.  Non-finite values become
        ``None`` — strict-JSON clients must not choke on NaN markers."""
        out = []
        for key in self.keys(name):
            labels = dict(key[1])
            if label_filter and any(labels.get(k) != str(v)
                                    for k, v in label_filter.items()):
                continue
            pts = self.points(key[0], labels, window_s)
            out.append({
                "name": key[0],
                "labels": labels,
                "points": [
                    [round(t, 4), round(v, 6) if math.isfinite(v) else None]
                    for t, v in pts],
            })
        return out

    def window_snapshot(self, window_s: float) -> dict:
        """The flight-recorder artifact block: every series clipped to
        the trailing window (the load trajectory into a crash)."""
        series = []
        for name in self.names():
            series.extend(self.export(name, window_s=window_s))
        return {"window_s": float(window_s),
                "t_mono": self._clock(),
                "series": series}
