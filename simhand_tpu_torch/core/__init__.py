from simhand_tpu_torch.core.geometry import (
    apply_affine_2d,
    convert_2_5d_to_3d,
    convert_to_2_5d,
    crop_box_from_joints,
    opencv_rotation_matrix,
    root_depth,
    rotation_matrix_2d,
)

__all__ = ["apply_affine_2d", "convert_2_5d_to_3d", "convert_to_2_5d", "crop_box_from_joints",
           "opencv_rotation_matrix", "root_depth", "rotation_matrix_2d"]
