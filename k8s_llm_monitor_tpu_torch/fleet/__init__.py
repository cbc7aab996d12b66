"""Fleet tier: route queries across N engine replicas.

One engine serves one card; this package scales the monitor *out*: a
``ReplicaRegistry`` tracks replica health and load, replica adapters put
in-process engines (``LocalReplica`` over the port's ``EngineService``)
and remote HTTP replicas behind one interface, and the ``FleetRouter``
dispatches with pluggable policies (least-loaded, prefix-affinity
rendezvous hashing), per-replica circuit breakers, hedged dispatch,
prefill→decode handoff over KVX1 and mid-stream failover with the
supervisor's idempotent-replay contract.  See docs/fleet.md.
"""

from k8s_llm_monitor_tpu_torch.fleet.autoscaler import (
    AutoscaleController, KubeScaleExecutor, LocalPoolExecutor)
from k8s_llm_monitor_tpu_torch.fleet.registry import (
    Candidate, ReplicaRegistry, ReplicaStats)
from k8s_llm_monitor_tpu_torch.fleet.replica import (
    HTTPReplica, LocalReplica, Replica, ReplicaUnavailable)
from k8s_llm_monitor_tpu_torch.fleet.router import (
    POLICIES, FleetRouter, HedgeConfig, LeastLoadedPolicy,
    PrefixAffinityPolicy, RoundRobinPolicy, RoutingPolicy)

__all__ = [
    "Candidate",
    "ReplicaRegistry",
    "ReplicaStats",
    "Replica",
    "ReplicaUnavailable",
    "LocalReplica",
    "HTTPReplica",
    "FleetRouter",
    "HedgeConfig",
    "RoutingPolicy",
    "RoundRobinPolicy",
    "LeastLoadedPolicy",
    "PrefixAffinityPolicy",
    "POLICIES",
    "AutoscaleController",
    "KubeScaleExecutor",
    "LocalPoolExecutor",
]
