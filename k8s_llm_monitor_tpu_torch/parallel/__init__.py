"""Tensor parallelism over the ``model`` axis: one process per rank on
``torch.distributed`` (mesh.py), the weights' and the KV pool's partition
specs (sharding.py) and the reduce-scatter / all-gather decode schedule
(overlap.py).  The JAX package's ``parallel`` counterpart."""

from k8s_llm_monitor_tpu_torch.parallel.mesh import (
    Mesh,
    MeshBroken,
    MeshConfig,
    create_mesh,
    parse_mesh_shape,
)
from k8s_llm_monitor_tpu_torch.parallel.sharding import (
    kv_pages_partition_specs,
    param_partition_specs,
    shard_params,
)

__all__ = [
    "Mesh",
    "MeshBroken",
    "MeshConfig",
    "create_mesh",
    "parse_mesh_shape",
    "param_partition_specs",
    "kv_pages_partition_specs",
    "shard_params",
]
