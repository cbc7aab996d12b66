"""The monitor's LLM backends over the port's engine (``analysis``)."""
