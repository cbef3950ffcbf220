from simhand_tpu_torch.losses.contrastive import (
    neg_weighted_nt_xent,
    nt_xent,
    pos_weighted_nt_xent,
    weighted_nt_xent,
)
from simhand_tpu_torch.losses.ntxent_kernels import (
    nt_xent_kernel,
    weighted_nt_xent_kernel,
)
from simhand_tpu_torch.losses.weights import (
    apply_pca,
    linear_weights,
    nonlinear_weights,
    pairwise_minmax,
)

__all__ = [
    "apply_pca",
    "linear_weights",
    "neg_weighted_nt_xent",
    "nonlinear_weights",
    "nt_xent",
    "nt_xent_kernel",
    "pairwise_minmax",
    "pos_weighted_nt_xent",
    "weighted_nt_xent",
    "weighted_nt_xent_kernel",
]
