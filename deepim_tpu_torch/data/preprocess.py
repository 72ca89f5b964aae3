"""Host-side test-sample preprocessing: image, depth and mask loading,
the observed-mask strategies and random mask dilation (the test half of
deepim_tpu/data/preprocess.py; its train half, make_train_sample,
VOCBackgrounds and sample_model_points, comes with the training driver).

Images are RGB float32 [0, 255], NCHW per sample; PNGs are decoded by
utils/png.py, which returns RGB directly.  Rendered colour images are not
loaded: the engine re-renders from pose_rendered.  resize_to acts only
when the devkit's resolution differs from SCALES; it resamples with
torch's bilinear interpolation (align_corners=False, no antialiasing),
cv2.resize's INTER_LINEAR rule, on float32 arrays.
"""
from __future__ import annotations

import random

import numpy as np
import torch
import torch.nn.functional as F

from deepim_tpu_torch.config import Config
from deepim_tpu_torch.utils.png import read_png


def resize_to(im: np.ndarray, target_size: int, max_size: int) -> tuple[np.ndarray, float]:
    """Scale so the short side == target_size, capped by max_size on the long
    side; output sizes round as cv2.resize rounds them.  Returns (image,
    scale); the image itself when the scale is 1."""
    h, w = im.shape[:2]
    short, long_ = min(h, w), max(h, w)
    scale = float(target_size) / short
    if round(scale * long_) > max_size:
        scale = float(max_size) / long_
    if scale == 1.0:
        return im, 1.0
    x = torch.from_numpy(np.ascontiguousarray(im, np.float32))
    x = x[None, None] if x.ndim == 2 else x.permute(2, 0, 1)[None]
    out = F.interpolate(x, size=(int(round(h * scale)), int(round(w * scale))), mode="bilinear",
                        align_corners=False, antialias=False)[0]
    out = out[0] if im.ndim == 2 else out.permute(1, 2, 0)
    return out.numpy(), scale


def load_image_rgb(path: str) -> np.ndarray:
    """Colour PNG -> (H, W, 3) float32 RGB (gray is repeated, alpha dropped)."""
    im = read_png(path)
    if im.dtype != np.uint8:
        raise ValueError(f"{path}: a colour image must be 8-bit, got {im.dtype}")
    if im.ndim == 2:
        im = np.repeat(im[:, :, None], 3, axis=2)
    return im[:, :, :3].astype(np.float32)


def load_depth(path: str, depth_factor: float) -> np.ndarray:
    return read_png(path).astype(np.float32) / depth_factor


def load_label_mask(path: str, mask_idx: int) -> np.ndarray:
    return (read_png(path) == mask_idx).astype(np.float32)


def load_gt_observed_mask(pair_rec: dict, depth_factor: float) -> np.ndarray:
    """Unresized gt mask of the observed side: the label image when present,
    else the gt-observed depth > 0.2 (flipped pairs, where the 'observed'
    side is a stored render with no label file)."""
    if pair_rec.get("mask_gt_observed"):
        return load_label_mask(pair_rec["mask_gt_observed"], pair_rec["mask_idx"])
    d = load_depth(pair_rec["depth_gt_observed"], depth_factor)
    return (d > 0.2).astype(np.float32)


def min_rect(mask: np.ndarray) -> tuple[int, int, int, int]:
    """(x_start, y_start, x_end, y_end) of the nonzero region
    (lib/utils/get_min_rect.py:9-23)."""
    nz_y, nz_x = np.nonzero(mask)
    return int(nz_x.min()), int(nz_y.min()), int(nz_x.max()), int(nz_y.max())


def box_mask_from(mask: np.ndarray) -> np.ndarray:
    out = np.zeros_like(mask)
    if mask.any():
        x0, y0, x1, y1 = min_rect(mask)
        out[y0:y1, x0:x1] = 1.0  # [start, end) as in the reference
    return out


def mask_dilate_np(mask: np.ndarray, rng: random.Random, max_thickness: int = 10) -> np.ndarray:
    """Random directional dilation (lib/utils/mask_dilate.py:10-47)."""
    direction = rng.randrange(10)
    out = mask.copy()

    def expand(m, t, axis, sign):
        if axis == 0 and sign > 0:
            out[t:, :] = np.maximum(out[t:, :], m[:-t, :])
        elif axis == 0:
            out[:-t, :] = np.maximum(out[:-t, :], m[t:, :])
        elif sign > 0:
            out[:, t:] = np.maximum(out[:, t:], m[:, :-t])
        else:
            out[:, :-t] = np.maximum(out[:, :-t], m[:, t:])

    if direction not in (0, 1, 4):
        expand(mask, rng.randrange(max_thickness) + 1, 0, +1)
    if direction not in (1, 2, 5):
        expand(mask, rng.randrange(max_thickness) + 1, 0, -1)
    if direction not in (2, 3, 6):
        expand(mask, rng.randrange(max_thickness) + 1, 1, +1)
    if direction not in (0, 3, 7):
        expand(mask, rng.randrange(max_thickness) + 1, 1, -1)
    return np.clip(out, 0, 1)


def make_test_sample(
    pair_rec: dict, cfg: Config, rng: random.Random | None = None,
) -> dict[str, np.ndarray]:
    """Build one test sample.  The observed mask follows TEST.INIT_MASK
    (image.py:297-378).  For the 'box_rendered' default without MASK_DILATE
    the engine reproduces the box on-device from its own render of
    pose_rendered (identical to the stored rendered depth's box), so a
    placeholder is emitted; with TEST.MASK_DILATE (image.py:380-381) the mask
    must be built and dilated on host, and the engine keeps it for the first
    iteration (EngineConfig.init_mask_host)."""
    target_size, max_size = cfg.SCALES[0]
    im_obs, _ = resize_to(load_image_rgb(pair_rec["image_observed"]), target_size, max_size)
    h, w = im_obs.shape[:2]

    init = cfg.TEST.INIT_MASK
    host_mask = True
    if init in ("mask_gt_observed", "box_gt_observed"):
        m = load_gt_observed_mask(pair_rec, cfg.dataset.DEPTH_FACTOR)
        m, _ = resize_to(m, target_size, max_size)
        m = (m >= 0.5).astype(np.float32)
        mask_obs = box_mask_from(m) if init.startswith("box") else m
    elif init in ("mask_observed", "box_"):
        # PoseCNN-predicted observed mask (image.py:314-356).
        m = load_label_mask(pair_rec["mask_observed"], pair_rec["mask_idx"])
        m, _ = resize_to(m, target_size, max_size)
        m = (m >= 0.5).astype(np.float32)
        mask_obs = box_mask_from(m) if init.startswith("box") else m
    elif init in ("box_rendered", "init"):
        if cfg.TEST.MASK_DILATE and "depth_rendered" in pair_rec:
            # Dilation needs the real box: build it from the stored rendered
            # depth like the reference (image.py:357-375).
            depth_rend = load_depth(pair_rec["depth_rendered"], cfg.dataset.DEPTH_FACTOR)
            depth_rend, _ = resize_to(depth_rend, target_size, max_size)
            mask_obs = box_mask_from((depth_rend > 0.2).astype(np.float32))
        else:
            # Engine recomputes from the on-device render; placeholder here.
            mask_obs = np.ones((h, w), np.float32)
            host_mask = False
    else:
        raise ValueError(f"Unsupported TEST.INIT_MASK {init}")
    if cfg.TEST.MASK_DILATE and host_mask:
        mask_obs = mask_dilate_np(mask_obs, rng if rng is not None else random.Random(0))

    sample = {
        "image_observed": im_obs.transpose(2, 0, 1),
        "mask_observed": mask_obs[None],
        "pose_rendered": np.asarray(pair_rec["pose_rendered"], np.float32),
        "pose_observed": np.asarray(pair_rec["pose_observed"], np.float32),
        "class_index": np.int32(0),
    }
    if cfg.network.INPUT_DEPTH:
        d_obs = load_depth(pair_rec["depth_observed"], cfg.dataset.DEPTH_FACTOR)
        d_obs, _ = resize_to(d_obs, target_size, max_size)
        sample["depth_observed"] = d_obs[None]
    return sample
