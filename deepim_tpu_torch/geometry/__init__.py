from deepim_tpu_torch.geometry.projection import project_points
from deepim_tpu_torch.geometry.rotations import euler2mat, mat2quat, quat2mat, quat_normalize
from deepim_tpu_torch.geometry.se3 import (
    R_transform,
    RT_transform,
    T_transform,
    make_pose,
    se3_inverse,
    se3_mul,
)

__all__ = [
    "project_points", "euler2mat", "mat2quat", "quat2mat", "quat_normalize",
    "R_transform", "RT_transform", "T_transform", "make_pose", "se3_inverse", "se3_mul",
]
