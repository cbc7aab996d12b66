"""Multi-turn diagnosis sessions pinned to a prefix-cached context.

A session freezes the cluster-context block at creation time and builds
every follow-up prompt as::

    preamble + pinned context + turn_1 Q/A + ... + new question

The pinned prefix is the point: the serving engine's PrefixCache (and the
fleet router's prefix-affinity policy) key on leading tokens, so every
follow-up in a session replays the same prefix — prefill work for the
shared context is paid once, and in fleet mode the whole conversation
lands on the replica whose KV pages already hold it.  Re-collecting
evidence per turn would defeat both.
"""

from __future__ import annotations

import time
import uuid
from typing import Callable

from k8s_llm_monitor_tpu_torch.devtools.lockcheck import guarded_by, make_lock

# Bound the replayed conversation so prompts can't grow without limit;
# older turns drop off while the pinned context stays.
MAX_TURNS = 8
MAX_ANSWER_CHARS = 800


class DiagnosisSession:
    def __init__(self, session_id: str, context: str,
                 clock: Callable[[], float] = time.monotonic) -> None:
        self.session_id = session_id
        self.context = context  # pinned — never mutated after creation
        self.turns: list[tuple[str, str]] = []
        self._clock = clock
        self.created_at = clock()
        self.last_used = clock()

    def build_prompt(self, preamble: str, question: str) -> str:
        """Prompt with the pinned context first, so its token prefix is
        byte-identical across every turn of the session."""
        self.last_used = self._clock()
        parts = [preamble, self.context]
        for q, a in self.turns[-MAX_TURNS:]:
            parts.append(f"## Question\n{q}\n## Answer\n{a}\n")
        parts.append(f"## Question\n{question}\n## Answer\n")
        return "".join(parts)

    def record(self, question: str, answer: str) -> None:
        self.turns.append((question, answer[:MAX_ANSWER_CHARS]))
        self.last_used = self._clock()


@guarded_by("_lock", "_sessions")
class SessionManager:
    """TTL + LRU-capped registry of pinned-context sessions.

    ``get_or_create(session_id, context_fn)`` returns the existing session
    (ignoring ``context_fn`` — the pin holds) or creates one with a fresh
    context; an empty id mints a new session.  Idle sessions past
    ``ttl_s`` are evicted lazily on access; beyond ``max_sessions`` the
    least-recently-used goes first.
    """

    def __init__(self, ttl_s: float = 600.0, max_sessions: int = 16,
                 clock: Callable[[], float] = time.monotonic) -> None:
        self.ttl_s = ttl_s
        self.max_sessions = max_sessions
        self._clock = clock
        self._sessions: dict[str, DiagnosisSession] = {}
        self._lock = make_lock("diagnosis.sessions")

    def _evict_locked(self) -> None:
        now = self._clock()
        stale = [sid for sid, s in self._sessions.items()
                 if now - s.last_used > self.ttl_s]
        for sid in stale:
            del self._sessions[sid]
        while len(self._sessions) > self.max_sessions:
            oldest = min(self._sessions.values(), key=lambda s: s.last_used)
            del self._sessions[oldest.session_id]

    def get_or_create(
        self, session_id: str,
        context_fn: Callable[[], str],
    ) -> tuple[DiagnosisSession, bool]:
        """Returns (session, created).  ``context_fn`` runs only on
        creation — and outside the lock, since evidence collection can be
        slow."""
        with self._lock:
            self._evict_locked()
            if session_id and session_id in self._sessions:
                return self._sessions[session_id], False
        context = context_fn()
        with self._lock:
            # Re-check: a concurrent request may have created it meanwhile;
            # first creation wins so both turns share one pinned prefix.
            if session_id and session_id in self._sessions:
                return self._sessions[session_id], False
            sid = session_id or uuid.uuid4().hex[:12]
            session = DiagnosisSession(sid, context, clock=self._clock)
            self._sessions[sid] = session
            self._evict_locked()
            return session, True

    def get(self, session_id: str) -> DiagnosisSession | None:
        with self._lock:
            self._evict_locked()
            return self._sessions.get(session_id)

    def __len__(self) -> int:
        with self._lock:
            return len(self._sessions)
