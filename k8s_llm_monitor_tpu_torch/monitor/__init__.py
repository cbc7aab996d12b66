"""The monitor over the port's engine: cluster access, metrics, the
Analysis Engine (``analysis``) and the HTTP API server (``server``)."""
