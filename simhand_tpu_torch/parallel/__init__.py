"""Data parallelism over ``torch.distributed`` (counterpart of
``simhand_tpu/parallel``): the data axis and its collectives."""
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
    "Axis",
    "ProcessGroupAxis",
    "create_mesh",
    "device_prefetch",
    "init_distributed",
    "replicate",
    "shard_batch",
]
