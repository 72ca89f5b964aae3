from deepim_tpu_torch.ops.masks import box_fill
from deepim_tpu_torch.ops.sampler import ZoomFactor, affine_sample, invert_zoom_factor
from deepim_tpu_torch.ops.zoom import (
    mask_bbox,
    zoom_factor_from_masks,
    zoom_images,
    zoom_mask,
    zoom_masks,
    zoom_trans,
)

__all__ = [
    "box_fill", "ZoomFactor", "affine_sample", "invert_zoom_factor", "mask_bbox",
    "zoom_factor_from_masks", "zoom_images", "zoom_mask", "zoom_masks", "zoom_trans",
]
