from simhand_tpu_torch.core.geometry import (
    apply_affine_2d,
    crop_box_from_joints,
    opencv_rotation_matrix,
    rotation_matrix_2d,
)

__all__ = ["apply_affine_2d", "crop_box_from_joints", "opencv_rotation_matrix",
           "rotation_matrix_2d"]
