from simhand_tpu_torch.data.sources.hand100m import Hand100MSource
from simhand_tpu_torch.data.sources.synthetic import (
    SyntheticHandSource,
    generate_synthetic_hand100m,
    write_synthetic_annotation,
)

__all__ = ["Hand100MSource", "SyntheticHandSource", "generate_synthetic_hand100m",
           "write_synthetic_annotation"]
