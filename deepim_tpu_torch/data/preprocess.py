"""Host-side sample preprocessing (counterpart of
deepim_tpu/data/preprocess.py): image, depth and mask loading, the
observed-mask strategies, random mask dilation, VOC background
substitution, model-point sampling, and the training and test samples.

Images are RGB float32 [0, 255], NCHW per sample; every image (colour,
depth, label, VOC background) is read by utils/imread.py in the mode of
its JAX site's cv2.imread call, PNG or JPEG by content.  Rendered colour
images are not loaded: the engine re-renders from pose_rendered.  resize_to acts only when the devkit's
resolution differs from SCALES; it samples where cv2.resize(fx=scale,
fy=scale, INTER_LINEAR) samples, and resize_to_size where cv2.resize(im,
(w, h), INTER_LINEAR) samples, on float32 arrays.
"""
from __future__ import annotations

import os
import random
import threading

import numpy as np
import torch

from deepim_tpu_torch.config import Config
from deepim_tpu_torch.utils.imread import imread


class DecodeCache:
    """In-memory cache of decoded and resized arrays, keyed by (kind, path,
    ...).  Decoded records are immutable inputs (every augmentation
    downstream allocates fresh arrays), so caching them across epochs is
    exact: epoch 2 on pays only augmentation and stacking.

    Entries are inserted until `budget_mb` is reached, then the cache stops
    growing (no eviction: each epoch is a reshuffle, so LRU would thrash).
    The loader's workers share one cache: a lock guards the table and the
    counters (not the decode), so two workers that miss on one key both
    decode it and the first one's array is kept.
    """

    def __init__(self, budget_mb: int = 4096):
        self.data: dict = {}
        self.budget = budget_mb * (1 << 20)
        self.bytes = 0
        self.hits = 0
        self.misses = 0
        self._lock = threading.Lock()

    def get(self, key, fn):
        with self._lock:
            out = self.data.get(key)
            if out is not None:
                self.hits += 1
                return out
            self.misses += 1
        out = fn()
        with self._lock:
            if key not in self.data and self.bytes + out.nbytes <= self.budget:
                # Entries are shared by reference: frozen, so an in-place
                # edit raises instead of corrupting every later epoch.
                out.flags.writeable = False
                self.data[key] = out
                self.bytes += out.nbytes
        return out


def _cached(cache: DecodeCache | None, key, fn):
    return fn() if cache is None else cache.get(key, fn)


def resize_to(im: np.ndarray, target_size: int, max_size: int) -> tuple[np.ndarray, float]:
    """Scale so the short side == target_size, capped by max_size on the long
    side.  Samples as cv2.resize(fx=scale, fy=scale) does: the output is
    round(h * scale) x round(w * scale) and output pixel x reads the input
    at (x + 0.5) / scale - 0.5, bilinearly (align_corners=False).  Sizing
    by the output size instead (F.interpolate(size=...)) maps pixels by
    in / out, which differs from 1 / scale whenever the size was rounded.
    Returns (image, scale); the image itself when the scale is 1."""
    h, w = im.shape[:2]
    short, long_ = min(h, w), max(h, w)
    scale = float(target_size) / short
    if round(scale * long_) > max_size:
        scale = float(max_size) / long_
    if scale == 1.0:
        return im, 1.0
    return _bilinear(im, int(round(h * scale)), int(round(w * scale)), scale), scale


def resize_to_size(im: np.ndarray, height: int, width: int) -> np.ndarray:
    """Resize to exactly (height, width) as cv2.resize(im, (width, height),
    INTER_LINEAR) does: output pixel x reads the input at (x + 0.5) * in /
    out - 0.5 on each axis, bilinearly.  A copy of the image itself when
    the size is already right."""
    if im.shape[:2] == (height, width):
        return im.copy()
    return _bilinear(im, height, width, None)


def _bilinear(im: np.ndarray, out_h: int, out_w: int, scale: float | None) -> np.ndarray:
    """(h, w) or (h, w, c) float32 -> (out_h, out_w[, c]) by
    upsample_bilinear2d (align_corners=False), mapping by 1 / scale, or by
    in / out on each axis when scale is None."""
    x = torch.from_numpy(np.ascontiguousarray(im, np.float32))
    x = x[None, None] if x.ndim == 2 else x.permute(2, 0, 1)[None]
    out = torch.ops.aten.upsample_bilinear2d(x, [out_h, out_w], False, scale, scale)[0]
    out = out[0] if im.ndim == 2 else out.permute(1, 2, 0)
    return out.numpy()


def load_image_rgb(path: str) -> np.ndarray:
    """A colour image -> (H, W, 3) float32 RGB, as cv2.imread(IMREAD_COLOR)
    reads it (gray repeated, alpha dropped, 16 bits cut to 8)."""
    return imread(path, "color").astype(np.float32)


def load_depth(path: str, depth_factor: float) -> np.ndarray:
    return imread(path, "unchanged").astype(np.float32) / depth_factor


def load_label_mask(path: str, mask_idx: int) -> np.ndarray:
    return (imread(path, "unchanged") == mask_idx).astype(np.float32)


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


class VOCBackgrounds:
    """VOC2012 background pool for synthetic observed images
    (lib/utils/image.py:97-155): the image ids listed with label 1 in
    <root_path>/VOCdevkit/VOC2012/ImageSets/Main/diningtable_trainval.txt,
    read from JPEGImages/<id>.jpg.  An empty or missing list makes
    replace_background a no-op, as on a tools/synth_data devkit."""

    def __init__(self, root_path: str):
        self.voc_root = os.path.join(root_path, "VOCdevkit/VOC2012")
        list_path = os.path.join(self.voc_root, "ImageSets/Main/diningtable_trainval.txt")
        self.bg_list: list[str] = []
        if os.path.exists(list_path):
            with open(list_path) as f:
                for line in f:
                    parts = line.strip().split()
                    if len(parts) == 2 and parts[1] == "1":
                        self.bg_list.append(parts[0])

    def replace_background(self, im_observed: np.ndarray, fg_mask: np.ndarray, rng: random.Random,
                           cache: DecodeCache | None = None) -> np.ndarray:
        """im_observed where fg_mask > 0, elsewhere a background drawn with
        rng.randrange(len(bg_list)), cropped from its top left to the
        observed aspect (rounding up) and resized to the observed size, as
        the JAX package does with cv2.  A listed file that does not exist
        leaves the image (cv2.imread's None).  `cache` memoizes the decoded
        image by path: decoding is pure, so no draw and no sample changes."""
        if not self.bg_list:
            return im_observed
        h, w = im_observed.shape[:2]
        idx = self.bg_list[rng.randrange(len(self.bg_list))]
        path = os.path.join(self.voc_root, f"JPEGImages/{idx}.jpg")
        if not os.path.isfile(path):
            return im_observed
        bg = _cached(cache, ("voc", path), lambda: imread(path, "color")).astype(np.float32)
        ratio = h / w
        bh, bw = bg.shape[:2]
        if bh >= bw * ratio:
            bg = bg[: int(np.ceil(bw * ratio)), :bw]
        else:
            bg = bg[:bh, : int(np.ceil(bh / ratio))]
        out = resize_to_size(bg, h, w)
        fg = fg_mask > 0
        out[fg] = im_observed[fg]
        return out


def sample_model_points(points: np.ndarray, num_sample: int, rng: np.random.RandomState):
    """Random NUM_3D_SAMPLE point subset, zero-padded, with weights
    (lib/utils/image.py:452-478)."""
    n = points.shape[0]
    keep = min(n, num_sample)
    idx = rng.permutation(n)[:keep]
    out = np.zeros((num_sample, 3), np.float32)
    out[:keep] = points[idx]
    weights = np.zeros((num_sample,), np.float32)
    weights[:keep] = 1.0
    return out, weights


def make_train_sample(
    pair_rec: dict,
    cfg: Config,
    points: np.ndarray,
    rng: random.Random,
    nprng: np.random.RandomState,
    voc: VOCBackgrounds | None = None,
    cache: DecodeCache | None = None,
) -> dict[str, np.ndarray]:
    """Build one training sample (numpy, NCHW) from a pair record: the
    observed image, the TRAIN.INIT_MASK observed mask (then MASK_DILATE),
    the gt mask and depth, both poses and, with SE3_PM_LOSS, sampled model
    points.  The rendered side and the labels that depend on it are made on
    the device by the training step.  `cache` memoizes the pure decode and
    resize stage across epochs; every augmentation stays per call.

    The random draws happen in the JAX package's order and under its
    conditions, so equal generators give equal samples: rng.random() only
    for a pair that is not data_syn when `voc` is given and
    REPLACE_OBSERVED_BG_RATIO > 0, then replace_background's draws, then
    mask_dilate_np's; nprng only for the point sample."""
    ts_ms = tuple(cfg.SCALES[0])
    im_obs = _cached(
        cache, ("img", pair_rec["image_observed"], ts_ms),
        lambda: resize_to(load_image_rgb(pair_rec["image_observed"]), *ts_ms)[0],
    )
    mask_src = pair_rec.get("mask_gt_observed") or pair_rec["depth_gt_observed"]
    mask_gt = _cached(
        cache, ("maskgt_raw", mask_src, pair_rec.get("mask_idx")),
        lambda: load_gt_observed_mask(pair_rec, cfg.dataset.DEPTH_FACTOR),
    )
    if pair_rec.get("data_syn", False) or (
        voc is not None and cfg.TRAIN.REPLACE_OBSERVED_BG_RATIO > 0
        and rng.random() < cfg.TRAIN.REPLACE_OBSERVED_BG_RATIO
    ):
        if voc is not None:
            im_obs = voc.replace_background(im_obs, mask_gt, rng, cache)

    mask_gt_r = _cached(
        cache, ("maskgt", mask_src, pair_rec.get("mask_idx"), ts_ms),
        lambda: (resize_to(mask_gt, *ts_ms)[0] >= 0.5).astype(np.float32),
    )

    def depth(key: str) -> np.ndarray:
        return _cached(cache, ("depth", pair_rec[key], ts_ms),
                       lambda: resize_to(load_depth(pair_rec[key], cfg.dataset.DEPTH_FACTOR), *ts_ms)[0])

    # INIT_MASK strategy (image.py:263-292).
    init = cfg.TRAIN.INIT_MASK
    if init == "mask_gt":
        mask_obs = mask_gt_r.copy()
    elif init == "box_gt":
        mask_obs = box_mask_from(mask_gt_r)
    elif init == "box_rendered":
        mask_obs = box_mask_from((depth("depth_rendered") > 0.2).astype(np.float32))
    else:
        raise ValueError(f"Unknown INIT_MASK {init}")
    if cfg.TRAIN.MASK_DILATE:
        mask_obs = mask_dilate_np(mask_obs, rng)

    sample = {
        "image_observed": im_obs.transpose(2, 0, 1),  # (3, H, W) raw RGB
        "mask_observed": mask_obs[None],
        "mask_gt_observed": mask_gt_r[None],
        "depth_gt_observed": depth("depth_gt_observed"),
        "pose_rendered": np.asarray(pair_rec["pose_rendered"], np.float32),
        "pose_observed": np.asarray(pair_rec["pose_observed"], np.float32),
        "class_index": np.int32(0),  # filled by the loader (class-name table)
    }
    if cfg.network.INPUT_DEPTH:
        sample["depth_observed"] = depth("depth_observed")[None]
    if cfg.train_iter.SE3_PM_LOSS:
        sample["points_model"], sample["points_weights"] = sample_model_points(
            points, cfg.train_iter.NUM_3D_SAMPLE, nprng)
    return sample


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
