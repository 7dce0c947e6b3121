"""Parallelism layer: device meshes and sharding rules.

The counterpart of the JAX package's ``parallel/``: DP, FSDP and TP
expressed as DTensor placements over a named ``DeviceMesh``, from the same
logical-axis rule tables. The pipeline (``pipeline_apply``,
``pipeline_loss_fn``, ``MPMDPipeline``) waits for ROADMAP A4.
"""
from .mesh import (
    AXIS_ORDER,
    MeshBootstrap,
    MeshSpec,
    best_effort_spec,
    make_mesh,
    single_device_mesh,
)
from .sharding import (
    DEFAULT_RULES,
    RULES_DP,
    RULES_FSDP,
    RULES_TP,
    constrain,
    logical_to_mesh_spec,
    named_sharding,
    replicated,
    shard_batch,
    tree_shardings,
)

__all__ = [
    "AXIS_ORDER",
    "MeshSpec",
    "MeshBootstrap",
    "make_mesh",
    "single_device_mesh",
    "best_effort_spec",
    "DEFAULT_RULES",
    "RULES_DP",
    "RULES_FSDP",
    "RULES_TP",
    "named_sharding",
    "logical_to_mesh_spec",
    "tree_shardings",
    "constrain",
    "shard_batch",
    "replicated",
]
