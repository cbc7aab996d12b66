"""Admission and failure handling shared by the engine and the service
(copies of the JAX package's stdlib-only modules): ``errors``
(``OverloadedError``), ``slo`` (SLO classes, the brownout ladder),
``tenancy`` (tenant names, the per-tenant governor), ``health`` (the
health state machine), ``retry`` (``Backoff``), ``faults`` (named
failure points for tests) and ``journal`` (the request write-ahead log the
engine supervisor replays)."""
