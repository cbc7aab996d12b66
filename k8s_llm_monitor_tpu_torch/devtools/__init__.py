"""Developer tooling: the lock-discipline checker (``lockcheck``)."""
