"""Admission-control errors shared by the serving and HTTP layers.

``OverloadedError`` is raised deep in the serving stack (load shedding,
drain, supervisor rebuild) but must be *mapped* by the HTTP layer — 429
for retriable sheds, 503 when this replica is going away — with a
``Retry-After`` header derived from the backoff hint.  It lives here,
stdlib-only, so an HTTP layer can import it without pulling the
torch-backed serving modules; ``serving/service.py`` re-exports it for
compatibility.
"""

from __future__ import annotations


class OverloadedError(Exception):
    """Admission refused by load shedding, drain, or an engine rebuild.

    Retriable: the caller should back off ``retry_after_s`` and retry
    (the HTTP layer maps this to 429 with a Retry-After header); when
    ``retriable`` is False this replica is going away and the client
    should retry against another replica (503).  Carries the backlog
    evidence so clients and logs see *why* they were shed.
    """

    def __init__(self, reason: str, queue_depth: int = 0,
                 queue_tokens: int = 0, retriable: bool = True,
                 retry_after_s: float = 1.0, slo_class: str = "",
                 request_id: str = "", tenant: str = ""):
        super().__init__(
            f"overloaded: {reason} "
            f"(queue_depth={queue_depth}, queue_tokens={queue_tokens})")
        self.reason = reason
        self.queue_depth = queue_depth
        self.queue_tokens = queue_tokens
        self.retriable = retriable
        self.retry_after_s = retry_after_s
        # Tenant the refusal is charged to ('' when the shedding layer is
        # tenant-unaware): the HTTP layer echoes it in the 429 body so a
        # rate-limited tenant can see the quota is *theirs*, not global.
        self.tenant = tenant
        # SLO class of the shed request ('' when the shed predates class
        # plumbing or the layer doesn't know): clients use it to pick the
        # per-class backoff lane, the HTTP layer echoes it in the 429 body.
        self.slo_class = slo_class
        # Request id assigned before the shed decision, echoed in the
        # 429/503 body so the refusal is joinable with traces and the
        # journal ('' when the shedding layer has no id to give).
        self.request_id = request_id
