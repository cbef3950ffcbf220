from simhand_tpu_torch.data.sources.synthetic import (
    SyntheticHandSource,
    generate_synthetic_hand100m,
)

__all__ = ["SyntheticHandSource", "generate_synthetic_hand100m"]
