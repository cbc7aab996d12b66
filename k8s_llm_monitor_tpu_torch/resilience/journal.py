"""Append-only request journal (WAL) for crash-safe serving.

Every admitted generation request is journaled *before* it reaches the
engine; emitted tokens are checkpointed as they stream off the device and
a tombstone marks completion.  After a crash — step-loop death, pod
eviction, SIGKILL mid-write — the recovery scanner reconstructs exactly
which requests were accepted but never finished and how many tokens each
already delivered, so the supervisor (serving/supervisor.py) can re-admit
them with the already-streamed tokens trimmed off.  The invariant this
file carries: **no accepted request is ever silently lost.**

On-disk format (one directory, numbered segments ``wal-<n>.log``):

    record  := type(u8) length(u32 LE) crc(u32 LE) payload
    payload := compact JSON (utf-8), length bytes
    crc     := crc32(type_byte + payload)

Record types: ADMIT (id, prompt token ids, sampling, deadline, arrival
wall-clock), PROGRESS (id, newly emitted token ids), COMPLETE (tombstone),
SEAL (clean close marker).  The scanner tolerates a torn or truncated
tail — a short header, an absurd length, a CRC mismatch or undecodable
payload ends that segment's scan without raising and without applying the
corrupt record.

Rotation + compaction: the active segment rolls over at
``segment_max_bytes``; any sealed-off segment referenced by no live
(incomplete) request holds only tombstoned history and is deleted.

Fsync policy (``fsync=``): ``always`` fsyncs every record (safest,
slowest), ``interval`` fsyncs at most every ``fsync_interval_s`` (default;
bounded loss window), ``never`` only flushes to the OS (CI speed — set via
``K8SLLM_JOURNAL_FSYNC=never``).

Stdlib-only and clock-injectable, like the rest of this package.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import re
import struct
import time
import zlib
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Iterable

from k8s_llm_monitor_tpu_torch.devtools.lockcheck import make_lock

logger = logging.getLogger("resilience.journal")

# Record types.
ADMIT = 1
PROGRESS = 2
COMPLETE = 3
SEAL = 4

_HEADER = struct.Struct("<BII")  # type, payload length, crc32
# A length beyond this is treated as tail corruption, not a real record
# (the largest legitimate payload is a full prompt's token ids).
_MAX_PAYLOAD = 1 << 26

_SEGMENT_RE = re.compile(r"^wal-(\d{8})\.log$")

FSYNC_POLICIES = ("always", "interval", "never")


@dataclass
class JournaledRequest:
    """One request's reconstructed state after a journal scan."""

    request_id: str
    prompt_ids: list[int] = field(default_factory=list)
    sampling: dict[str, Any] = field(default_factory=dict)
    deadline_s: float = 0.0
    arrival_unix: float = 0.0
    emitted: list[int] = field(default_factory=list)
    completed: bool = False
    # SLO class (resilience/slo.py); pre-class WALs default to "standard".
    slo_class: str = "standard"
    # Tenant namespace (resilience/tenancy.py); pre-tenancy WALs default
    # to "public" — replay restores per-tenant quota reservations from
    # this field, so a crash cannot launder one tenant's quota into
    # another's.
    tenant: str = "public"


def _pack(rtype: int, payload: dict[str, Any]) -> bytes:
    body = json.dumps(payload, separators=(",", ":")).encode()
    crc = zlib.crc32(bytes((rtype,)) + body) & 0xFFFFFFFF
    return _HEADER.pack(rtype, len(body), crc) + body


def _iter_records(data: bytes, path: str) -> Iterable[tuple[int, dict]]:
    """Yield (type, payload) records; stop silently at a torn tail."""
    off = 0
    while off < len(data):
        if off + _HEADER.size > len(data):
            logger.warning("journal %s: truncated header at byte %d "
                           "(torn tail, %d byte(s) dropped)",
                           path, off, len(data) - off)
            return
        rtype, length, crc = _HEADER.unpack_from(data, off)
        body_start = off + _HEADER.size
        if length > _MAX_PAYLOAD or body_start + length > len(data):
            logger.warning("journal %s: truncated record at byte %d "
                           "(torn tail)", path, off)
            return
        body = data[body_start:body_start + length]
        if zlib.crc32(bytes((rtype,)) + body) & 0xFFFFFFFF != crc:
            logger.warning("journal %s: CRC mismatch at byte %d — dropping "
                           "the rest of the segment", path, off)
            return
        try:
            payload = json.loads(body)
        except ValueError:
            logger.warning("journal %s: undecodable payload at byte %d — "
                           "dropping the rest of the segment", path, off)
            return
        if not isinstance(payload, dict):
            logger.warning("journal %s: non-object payload at byte %d — "
                           "dropping the rest of the segment", path, off)
            return
        yield rtype, payload
        off = body_start + length


def _segment_paths(directory: Path) -> list[tuple[int, Path]]:
    out = []
    try:
        names = os.listdir(directory)
    except FileNotFoundError:
        return []
    for name in names:
        m = _SEGMENT_RE.match(name)
        if m:
            out.append((int(m.group(1)), directory / name))
    out.sort()
    return out


def scan_journal(directory: str | Path) -> tuple[dict[str, JournaledRequest], bool]:
    """Recover request state from every segment in ``directory``.

    Returns ``(requests, sealed)`` where ``requests`` maps request id to
    its reconstructed state (check ``.completed``) and ``sealed`` is True
    when the journal ends with a clean-close SEAL marker.  Never raises on
    torn/corrupt data: scanning a segment stops at the first bad record
    (everything before it is applied; nothing after it can be trusted).
    """
    directory = Path(directory)
    requests: dict[str, JournaledRequest] = {}
    sealed = False
    for _, path in _segment_paths(directory):
        try:
            data = path.read_bytes()
        except OSError as exc:
            logger.warning("journal %s: unreadable (%s) — skipped", path, exc)
            continue
        for rtype, payload in _iter_records(data, str(path)):
            sealed = rtype == SEAL  # only a SEAL as the *last* record counts
            if rtype == SEAL:
                continue
            rid = payload.get("id")
            if not isinstance(rid, str) or not rid:
                continue
            if rtype == ADMIT:
                req = requests.setdefault(rid, JournaledRequest(rid))
                req.prompt_ids = [int(t) for t in payload.get("prompt", [])]
                req.sampling = dict(payload.get("sampling") or {})
                req.deadline_s = float(payload.get("deadline_s", 0.0))
                req.arrival_unix = float(payload.get("arrival", 0.0))
                req.slo_class = str(payload.get("slo_class", "standard"))
                req.tenant = str(payload.get("tenant", "public"))
            elif rtype == PROGRESS:
                req = requests.get(rid)
                if req is None:
                    continue  # admit lost to earlier corruption/compaction
                req.emitted.extend(int(t) for t in payload.get("tokens", []))
            elif rtype == COMPLETE:
                req = requests.get(rid)
                if req is not None:
                    req.completed = True
    return requests, sealed


class RequestJournal:
    """Segmented append-only WAL with CRC records and live-ref compaction.

    Construction scans any prior segments in ``directory`` (exposed as
    ``recovered`` / ``recovered_sealed`` for the supervisor's warm-start
    replay) and then opens a *fresh* segment — a possibly-torn tail is
    never appended to.  Incomplete recovered requests keep their old
    segments pinned until this journal tombstones them.
    """

    def __init__(self, directory: str | Path, *,
                 segment_max_bytes: int = 4 << 20,
                 fsync: str | None = None,
                 fsync_interval_s: float = 0.05,
                 clock=time.monotonic):
        if fsync is None:
            fsync = os.environ.get("K8SLLM_JOURNAL_FSYNC", "") or "interval"
        if fsync not in FSYNC_POLICIES:
            raise ValueError(
                f"fsync policy {fsync!r} not in {FSYNC_POLICIES}")
        self.directory = Path(directory)
        self.directory.mkdir(parents=True, exist_ok=True)
        self.segment_max_bytes = max(int(segment_max_bytes), 1024)
        self.fsync = fsync
        self.fsync_interval_s = fsync_interval_s
        self._clock = clock
        self._last_fsync = clock()
        self._closed = False

        # Monotonic totals (exporter / tests).
        self.records_written = 0
        self.bytes_written = 0
        self.admits = 0
        self.completes = 0
        self.compacted_segments = 0

        segments = _segment_paths(self.directory)
        self._seg_sizes: dict[int, int] = {
            idx: path.stat().st_size for idx, path in segments
            if path.exists()
        }
        self.recovered, self.recovered_sealed = scan_journal(self.directory)
        # Incomplete recovered requests pin every pre-existing segment
        # (their records may be anywhere in prior history).
        self._live_refs: dict[str, set[int]] = {}
        for rid, req in self.recovered.items():
            if not req.completed:
                self._live_refs[rid] = {idx for idx, _ in segments}

        self._seg_index = (segments[-1][0] + 1) if segments else 0
        self._fh = open(self._seg_path(self._seg_index), "ab")
        self._seg_sizes[self._seg_index] = 0
        self._lock = make_lock("resilience.journal")
        self._compact_locked()

    # -- paths / sizes ---------------------------------------------------

    def _seg_path(self, index: int) -> Path:
        return self.directory / f"wal-{index:08d}.log"

    @property
    def size_bytes(self) -> int:
        """Bytes on disk across live (non-compacted) segments."""
        with self._lock:
            return sum(self._seg_sizes.values())

    @property
    def incomplete_recovered(self) -> list[JournaledRequest]:
        return [r for r in self.recovered.values() if not r.completed]

    # -- write path ------------------------------------------------------

    def _append_locked(self, rtype: int, payload: dict[str, Any],
                       force_sync: bool = False) -> None:
        if self._closed:
            return
        rec = _pack(rtype, payload)
        self._fh.write(rec)
        self._fh.flush()
        self.records_written += 1
        self.bytes_written += len(rec)
        self._seg_sizes[self._seg_index] = (
            self._seg_sizes.get(self._seg_index, 0) + len(rec))
        if self.fsync == "always" or force_sync:
            os.fsync(self._fh.fileno())
            self._last_fsync = self._clock()
        elif self.fsync == "interval":
            now = self._clock()
            if now - self._last_fsync >= self.fsync_interval_s:
                os.fsync(self._fh.fileno())
                self._last_fsync = now
        if self._seg_sizes[self._seg_index] >= self.segment_max_bytes:
            self._rotate_locked()

    def _rotate_locked(self) -> None:
        os.fsync(self._fh.fileno())
        self._fh.close()
        self._seg_index += 1
        self._fh = open(self._seg_path(self._seg_index), "ab")
        self._seg_sizes[self._seg_index] = 0
        self._compact_locked()

    def _compact_locked(self) -> None:
        """Drop non-active segments referenced by no live request — they
        hold only completed history."""
        pinned: set[int] = set()
        for refs in self._live_refs.values():
            pinned |= refs
        for idx in list(self._seg_sizes):
            if idx == self._seg_index or idx in pinned:
                continue
            try:
                self._seg_path(idx).unlink(missing_ok=True)
            except OSError as exc:
                logger.warning("journal compaction: cannot remove segment "
                               "%d (%s)", idx, exc)
                continue
            del self._seg_sizes[idx]
            self.compacted_segments += 1

    # -- public logging API ----------------------------------------------

    def log_admit(self, request_id: str, prompt_ids: list[int],
                  sampling: Any, deadline_s: float = 0.0,
                  arrival_unix: float | None = None,
                  slo_class: str = "standard",
                  tenant: str = "public") -> None:
        """Journal an accepted request BEFORE it reaches the engine
        (write-ahead).  ``sampling`` may be a SamplingParams dataclass or a
        plain dict.  ``tenant`` rides the ADMIT record so a warm-start
        replay restores per-tenant quota reservations exactly."""
        if dataclasses.is_dataclass(sampling):
            sampling = dataclasses.asdict(sampling)
        payload = {
            "id": request_id,
            "prompt": [int(t) for t in prompt_ids],
            "sampling": sampling or {},
            "deadline_s": float(deadline_s),
            "arrival": time.time() if arrival_unix is None else arrival_unix,
            "slo_class": slo_class,
            "tenant": tenant,
        }
        with self._lock:
            self._live_refs.setdefault(request_id, set()).add(self._seg_index)
            self._append_locked(ADMIT, payload)
            self.admits += 1

    def log_progress(self, request_id: str, token_ids: list[int]) -> None:
        if not token_ids:
            return
        with self._lock:
            if request_id in self._live_refs:
                self._live_refs[request_id].add(self._seg_index)
            self._append_locked(PROGRESS, {
                "id": request_id,
                "tokens": [int(t) for t in token_ids],
            })

    def log_complete(self, request_id: str) -> None:
        with self._lock:
            self._append_locked(COMPLETE, {"id": request_id})
            self.completes += 1
            self._live_refs.pop(request_id, None)
            self._compact_locked()

    def seal(self) -> None:
        """Clean-close marker + final fsync.  Incomplete requests (drain
        timeout stragglers) remain replayable by the next process."""
        with self._lock:
            if self._closed:
                return
            self._append_locked(SEAL, {"id": ""}, force_sync=True)
            self._closed = True
            self._fh.close()

    def close(self) -> None:
        """Flush and close without a SEAL (crash-like close; everything
        incomplete stays replayable)."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            try:
                self._fh.flush()
                os.fsync(self._fh.fileno())
            except OSError:
                pass
            self._fh.close()
