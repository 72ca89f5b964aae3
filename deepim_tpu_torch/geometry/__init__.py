from deepim_tpu_torch.geometry import pose_metrics, projection, rotations, se3  # noqa: F401
from deepim_tpu_torch.geometry.projection import pixel_grid, project_points
from deepim_tpu_torch.geometry.rotations import (
    euler2mat,
    mat2euler,
    mat2quat,
    qmult,
    quat2mat,
    quat_angle_deg,
    quat_inverse,
    quat_normalize,
    rot_geodesic_deg,
)
from deepim_tpu_torch.geometry.se3 import (
    R_inv_transform,
    R_transform,
    RT_transform,
    T_inv_transform,
    T_transform,
    calc_RT_delta,
    make_pose,
    se3_inverse,
    se3_mul,
)

__all__ = [
    "pixel_grid", "project_points", "euler2mat", "mat2euler", "mat2quat", "qmult", "quat2mat", "quat_angle_deg",
    "quat_inverse", "quat_normalize", "rot_geodesic_deg",
    "R_inv_transform", "R_transform", "RT_transform", "T_inv_transform", "T_transform",
    "calc_RT_delta", "make_pose", "se3_inverse", "se3_mul",
]
