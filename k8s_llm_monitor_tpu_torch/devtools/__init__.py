"""graftcheck for the port: static analysis, contract checks and engine
guards, one CLI (``python -m k8s_llm_monitor_tpu_torch.devtools.graftcheck``).

  * :mod:`~k8s_llm_monitor_tpu_torch.devtools.astlint` — AST rules (host
    reads inside a CUDA graph's capture, blocking calls under locks, bare
    excepts, mutable defaults, raw locks, the fault-point registry, the
    privacy and cluster-write rules);
  * :mod:`~k8s_llm_monitor_tpu_torch.devtools.dataflow` — the call graph:
    blocking calls reachable from the serving hot path, host reads and
    syncs reachable from a captured decode program, lock-order cycles;
  * :mod:`~k8s_llm_monitor_tpu_torch.devtools.contracts` — routes, metric
    families and environment keys against README.md and docs/;
  * :mod:`~k8s_llm_monitor_tpu_torch.devtools.traceguard` — runs the
    engine: no new decode program or CUDA-graph capture on a same-bucket
    repeat, no host sync in a replay, live buffers after resets;
  * :mod:`~k8s_llm_monitor_tpu_torch.devtools.lockcheck` — the
    instrumented-lock mode (``K8SLLM_LOCKCHECK=1``).

This ``__init__`` is import-free on purpose: ``lockcheck`` is imported by
low-level modules and must not drag the lint machinery in with it.
"""
