"""Executable entrypoints (``python -m k8s_llm_monitor_tpu_torch.cmd.<name>``)."""
