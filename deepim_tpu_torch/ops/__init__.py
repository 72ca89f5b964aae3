from deepim_tpu_torch.ops.flow import flow_from_depth, flow_from_depth_kt, gather_at_flow_target
from deepim_tpu_torch.ops.group_picker import group_pick
from deepim_tpu_torch.ops.masks import box_fill, mask_dilate, mask_dilate_random
from deepim_tpu_torch.ops.pointmatch import transform3d
from deepim_tpu_torch.ops.sampler import ZoomFactor, affine_sample, invert_zoom_factor
from deepim_tpu_torch.ops.zoom import (
    mask_bbox,
    zoom_depths,
    zoom_factor_from_images,
    zoom_factor_from_masks,
    zoom_flow,
    zoom_images,
    zoom_mask,
    zoom_masks,
    zoom_trans,
)

__all__ = [
    "flow_from_depth", "flow_from_depth_kt", "gather_at_flow_target", "box_fill", "mask_dilate",
    "mask_dilate_random", "group_pick", "transform3d",
    "ZoomFactor", "affine_sample", "invert_zoom_factor", "mask_bbox", "zoom_depths", "zoom_factor_from_images",
    "zoom_factor_from_masks",
    "zoom_flow", "zoom_images", "zoom_mask", "zoom_masks", "zoom_trans",
]
