"""Host-side request tracing, latency histograms and the flight recorder
(copies of the JAX package's ``tracing``, ``metrics`` and ``flight``)."""
