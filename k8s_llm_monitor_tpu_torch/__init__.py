"""PyTorch / CUDA port of the monitor's serving path for NVIDIA Hopper.

The JAX package ``k8s_llm_monitor_tpu`` is the reference; this package
mirrors its module names (``models``, ``ops``, ``serving``, ``monitor``,
``diagnosis``, ``resilience``, ``cmd``, ...) and imports nothing of it.  The attention kernels are hand-written CUDA C++
under ``csrc/``, built with ``nvcc`` on first use (``ops/_build.py``).
"""
