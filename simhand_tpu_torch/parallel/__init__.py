"""Data parallelism and FSDP over ``torch.distributed`` (counterpart of
``simhand_tpu/parallel``): the data axis and its collectives, the hybrid
mesh and the ZeRO-3 layout of the train state."""
from simhand_tpu_torch.parallel.fsdp import (
    FSDP_AXIS,
    FSDPMesh,
    FSDPTrainState,
    as_mesh,
    create_hybrid_mesh,
    fsdp_sharding,
    gathered,
    leaf_partition_spec,
    make_fsdp_train_step,
    shard_state,
    state_bytes,
)
from simhand_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    Axis,
    ProcessGroupAxis,
    create_mesh,
    device_prefetch,
    init_distributed,
    replicate,
    shard_batch,
)

__all__ = [
    "DATA_AXIS",
    "FSDP_AXIS",
    "Axis",
    "FSDPMesh",
    "FSDPTrainState",
    "ProcessGroupAxis",
    "as_mesh",
    "create_hybrid_mesh",
    "create_mesh",
    "device_prefetch",
    "fsdp_sharding",
    "gathered",
    "init_distributed",
    "leaf_partition_spec",
    "make_fsdp_train_step",
    "replicate",
    "shard_batch",
    "shard_state",
    "state_bytes",
]
