"""The render-and-compare refinement engine (PyTorch counterpart of
deepim_tpu/engine/refine.py).

One iteration renders the mesh at the current pose, updates the observed
mask, computes the zoom crop, runs the matching network on the zoomed
(observed, rendered) pair and applies the untangled SE(3) delta.  `refine`
is a Python loop over iterations (the JAX package's lax.scan).

Mask strategies (update_mask): 'box_rendered' rebuilds the observed-mask
rectangle from each iteration's render; 'box_observed' boxes the network's
predicted mask of the previous iteration, inverse-zoomed to the full
frame (the first iteration boxes the loader's mask); 'init', 'box_gt' and
'mask_gt' keep the loader's observed mask.  Also supported: depth input
channels (input_depth), the zoom factor from the image foregrounds
(input_mask=False), per-class SE(3) heads selected by class_index (a
network with num_regressors > 1) and Euler-angle rotation heads, the
image zoom in bf16 (zoom_dtype, bf16 on the card), renders lit by a point
light at the current pose (Observation.light with mesh normals: the
unseen-object evaluation) and per-fragment texture sampling
(texture_sampling with a bank built with keep_textures).
"""
from __future__ import annotations

import dataclasses
import logging
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from deepim_tpu_torch.config import Config
from deepim_tpu_torch.device import resolve_device
from deepim_tpu_torch.geometry.se3 import RT_transform
from deepim_tpu_torch.models.flownet import assemble_input
from deepim_tpu_torch.ops.masks import box_fill
from deepim_tpu_torch.ops.zoom import (
    zoom_depths,
    zoom_factor_from_images,
    zoom_factor_from_masks,
    zoom_images,
    zoom_mask,
    zoom_masks,
    zoom_trans,
)
from deepim_tpu_torch.render.lighting import lit_vertex_colors
from deepim_tpu_torch.render.rasterizer import (
    RasterConfig,
    expand_corners,
    gather_corners,
    rasterize,
    rasterize_textured,
    render_mask,
    uses_csr,
)
from deepim_tpu_torch.utils import tracing

log = logging.getLogger(__name__)

_MASK_STRATEGIES = ("box_rendered", "box_observed", "init", "box_gt", "mask_gt")


@dataclass(frozen=True)
class EngineConfig:
    """Static refinement parameters (field-for-field copy of the JAX
    EngineConfig; see _check_supported for the values this port runs)."""

    height: int = 480
    width: int = 640
    raster: RasterConfig = RasterConfig()
    rot_coord: str = "CAMERA"
    rot_type: str = "QUAT"
    trans_means: tuple[float, float, float] = (0.0, 0.0, 0.0)
    trans_stds: tuple[float, float, float] = (1.0, 1.0, 1.0)
    pixel_means: tuple[float, float, float] = (0.0, 0.0, 0.0)
    input_depth: bool = False
    input_mask: bool = True
    pred_flow: bool = True
    pred_mask: bool = True
    update_mask: str = "box_rendered"
    normalize_flow: float = 20.0
    normalize_3d_point: float = 0.1
    standard_flow_rep: bool = False
    mask_thresh: float = 0.2
    depth_factor_for_input: float = 255.0
    num_iters: int = 4
    texture_sampling: bool = False
    init_mask_host: bool = False
    # Dtype of the image zoom ('float32' | 'bfloat16'); masks, depths and
    # flow labels always zoom in float32.
    zoom_dtype: str = "float32"

    @staticmethod
    def from_config(cfg: Config, train: bool = False, bank_arrays=None,
                    device="cuda") -> "EngineConfig":
        """Build from a Config.  Pass the mesh bank (`bank_arrays`, as
        MeshBuffers.gather takes it) so the CSR pair budget is sized from
        the bank's face geometry (tune_raster_for_bank), as every driver
        does.  The image zoom is bf16 on a CUDA `device` and float32 on the
        CPU, as the JAX package picks bf16 on its accelerator and float32
        on the CPU."""
        ecfg = EngineConfig(
            height=cfg.height,
            width=cfg.width,
            raster=RasterConfig(height=cfg.height, width=cfg.width, znear=cfg.dataset.ZNEAR,
                                zfar=cfg.dataset.ZFAR),
            rot_coord=cfg.network.ROT_COORD,
            rot_type=cfg.network.ROT_TYPE,
            trans_means=cfg.dataset.trans_means,
            trans_stds=cfg.dataset.trans_stds,
            pixel_means=cfg.network.PIXEL_MEANS,
            input_depth=cfg.network.INPUT_DEPTH,
            input_mask=cfg.network.INPUT_MASK,
            pred_flow=cfg.network.PRED_FLOW,
            pred_mask=cfg.network.PRED_MASK,
            update_mask=(cfg.TRAIN.UPDATE_MASK if train else cfg.TEST.UPDATE_MASK),
            normalize_flow=cfg.dataset.NORMALIZE_FLOW,
            normalize_3d_point=cfg.dataset.NORMALIZE_3D_POINT,
            standard_flow_rep=cfg.network.STANDARD_FLOW_REP,
            num_iters=(cfg.network.TRAIN_ITER_SIZE if train else cfg.TEST.test_iter),
            init_mask_host=(not train) and cfg.TEST.MASK_DILATE,
            texture_sampling=cfg.dataset.TEXTURE_SAMPLING,
            zoom_dtype="bfloat16" if torch.device(device).type == "cuda" else "float32",
        )
        if bank_arrays is not None:
            ecfg = tune_raster_for_bank(ecfg, bank_arrays, cfg.dataset.intrinsic_matrix())
        return ecfg


_ZOOM_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _check_supported(ecfg: EngineConfig) -> None:
    if ecfg.update_mask not in _MASK_STRATEGIES:
        raise NotImplementedError(f"update_mask={ecfg.update_mask!r} is no mask strategy of the port's "
                                  f"(one of {_MASK_STRATEGIES})")
    if ecfg.zoom_dtype not in _ZOOM_DTYPES:
        raise ValueError(f"zoom_dtype must be one of {sorted(_ZOOM_DTYPES)}, got {ecfg.zoom_dtype!r}")


def tune_raster_for_bank(ecfg: EngineConfig, bank_arrays, k=None,
                         max_pairs_per_sample: int = 4_000_000,
                         z_min: float | None = None) -> EngineConfig:
    """Size the CSR pair budget (bin_pairs, or tiered csr_tiers for
    heavy-tailed banks) from the bank's face geometry so no pose with
    z >= max(znear, z_min) truncates.  A pack unit of diameter d spans at
    most d (f + 2 extent) / z pixels per axis.  No-op on the dense path or
    with an explicit bin_pairs.  bank_arrays: dict or (verts, colors,
    faces, valid) tuple of numpy arrays."""
    if isinstance(bank_arrays, dict):
        verts, faces, fvalid = bank_arrays["vertices"], bank_arrays["faces"], bank_arrays["face_valid"]
    else:
        verts, _, faces, fvalid = bank_arrays[:4]
    verts, faces, fvalid = (np.asarray(x) for x in (verts, faces, fvalid))
    f_padded = faces.shape[1]
    rcfg = ecfg.raster
    if not uses_csr(rcfg, f_padded) or rcfg.bin_pairs:
        return ecfg

    corners = np.take_along_axis(
        verts, faces.reshape(faces.shape[0], -1)[..., None], axis=1
    ).reshape(faces.shape[0], f_padded, 3, 3)
    pack = 1
    if rcfg.csr_pack > 1 and f_padded % rcfg.csr_pack == 0 and rcfg.csr_chunk % rcfg.csr_pack == 0:
        pack = rcfg.csr_pack
    n_units = f_padded // pack
    c = corners.shape[0]
    if pack > 1:
        c4 = corners.reshape(c, n_units, pack, 3, 3)
        v4 = fvalid.reshape(c, n_units, pack)
        # Invalid faces collapse onto the unit's first valid corner so they
        # cannot inflate the union.
        first = np.argmax(v4, axis=2)
        ref = np.take_along_axis(c4[:, :, :, 0, :], first[..., None, None], axis=2)[:, :, 0]
        corners = np.where(v4[..., None, None], c4, ref[:, :, None, None, :]).reshape(
            c, n_units, pack * 3, 3
        )
        fvalid = v4.any(axis=2)
    diffs = corners[:, :, :, None, :] - corners[:, :, None, :, :]
    diam = np.where(fvalid, np.linalg.norm(diffs, axis=-1).max(axis=(2, 3)), 0.0)
    if not fvalid.any():
        return ecfg
    if k is not None:
        kk = np.asarray(k, np.float32).reshape(3, 3)
        fx, fy = float(kk[0, 0]), float(kk[1, 1])
    else:
        fx = fy = float(max(rcfg.width, rcfg.height))
    zlo = max(rcfg.znear, z_min or 0.0)
    th, tw = rcfg.csr_tile_h, rcfg.csr_tile_w
    n_tiles = (-(-rcfg.height // th)) * (-(-rcfg.width // tw))
    d_u = diam.max(axis=0)
    px = d_u * (fx + 2.0 * rcfg.width) / zlo
    py = d_u * (fy + 2.0 * rcfg.height) / zlo
    span_u = np.minimum(
        (np.ceil(px / tw).astype(np.int64) + 1) * (np.ceil(py / th).astype(np.int64) + 1),
        n_tiles,
    )
    span_u = np.maximum(span_u, 1)
    s_max = int(span_u.max())

    def uniform(reason: str | None):
        s = min(s_max, max(1, max_pairs_per_sample // n_units))
        if reason is not None:
            log.warning("tune_raster_for_bank: %s; using a capped uniform %d tiles/unit", reason, s)
        elif s < s_max:
            log.warning(
                "tune_raster_for_bank: exact CSR budget needs %d tiles/unit but the "
                "%d-pair cap allows %d; wider faces will drop pairs", s_max,
                max_pairs_per_sample, s,
            )
        return dataclasses.replace(
            ecfg, raster=dataclasses.replace(rcfg, bin_pairs=n_units * s, csr_tiers=())
        )

    if s_max <= 2 * max(1, int(span_u.min())) or n_units < 2:
        return uniform(None)
    lvl = np.maximum(8, 1 << np.ceil(np.log2(span_u)).astype(np.int64))
    lvl = np.minimum(lvl, n_tiles)
    tiers: list[tuple[int, int]] = []
    run_lvl = int(lvl[0])
    for i in range(1, n_units):
        if int(lvl[i]) != run_lvl:
            tiers.append((i, run_lvl))
            run_lvl = int(lvl[i])
    tiers.append((n_units, run_lvl))
    total = sum((end - (tiers[i - 1][0] if i else 0)) * s for i, (end, s) in enumerate(tiers))
    if len(tiers) > 16 or total > max_pairs_per_sample:
        return uniform(f"{len(tiers)} tier runs / {total} pairs exceed the budget shape")
    return dataclasses.replace(
        ecfg, raster=dataclasses.replace(rcfg, bin_pairs=int(total), csr_tiers=tuple(tiers))
    )


class MeshBuffers(NamedTuple):
    """Per-sample mesh tensors, gathered from a MeshBank by class index."""

    vertices: torch.Tensor    # (B, V, 3)
    colors: torch.Tensor      # (B, V, 3)
    faces: torch.Tensor       # (B, F, 3) int32
    face_valid: torch.Tensor  # (B, F) bool
    normals: torch.Tensor | None = None   # (B, V, 3), for the lit (ModelNet) render
    uv: torch.Tensor | None = None        # (B, V, 2), for texture sampling
    textures: torch.Tensor | None = None  # (B, TH, TW, 3)
    # Pose-independent face corners (vertices[faces], colors[faces]),
    # expanded once per batch so each render skips the gather.
    corners: torch.Tensor | None = None
    corner_colors: torch.Tensor | None = None

    def expand_corners(self) -> "MeshBuffers":
        if self.corners is not None:
            return self
        corners, corner_colors = expand_corners(self.vertices, self.colors, self.faces)
        return self._replace(corners=corners, corner_colors=corner_colors)

    @staticmethod
    def gather(bank_arrays, class_index, device="cuda") -> "MeshBuffers":
        """bank_arrays: a dict with vertices/colors/faces/face_valid and
        optionally normals, uv and textures (MeshBank.arrays()), or the
        tuple (vertices, colors, faces, face_valid[, normals]), of numpy
        arrays or tensors on any device; class_index: (B,) ints (numpy or a
        tensor on any device).  Each array is indexed where it lies, then
        moved to `device`."""
        dev = resolve_device(device)
        keys = ("vertices", "colors", "faces", "face_valid", "normals", "uv", "textures")
        if isinstance(bank_arrays, dict):
            arrs = [bank_arrays.get(k) for k in keys]
        else:
            arrs = list(bank_arrays[:5]) + [None] * (len(keys) - len(bank_arrays[:5]))
        idx = torch.as_tensor(class_index).long()
        out = []
        for a in arrs:
            if a is not None:
                a = a if isinstance(a, torch.Tensor) else torch.as_tensor(np.asarray(a))
                a = a[idx.to(a.device)].to(dev)
            out.append(a)
        return MeshBuffers(*out).expand_corners()

    def to(self, device) -> "MeshBuffers":
        return MeshBuffers(*(None if x is None else x.to(device) for x in self))


class LightParams(NamedTuple):
    """Per-sample point-light parameters of the unseen-object render."""

    position: torch.Tensor          # (B, 3) or (3,), camera frame
    intensity: torch.Tensor         # (B, 3) or (3,)
    brightness_ratio: torch.Tensor  # (B,) or a scalar

    def to(self, device) -> "LightParams":
        return LightParams(*(x.to(device) if isinstance(x, torch.Tensor) else x for x in self))


class Observation(NamedTuple):
    """Per-batch data fixed across refinement iterations."""

    image_observed: torch.Tensor             # (B, 3, H, W) RGB, raw [0, 255]
    mask_observed: torch.Tensor              # (B, 1, H, W)
    mask_gt_observed: torch.Tensor | None    # (B, 1, H, W); None at test time
    depth_observed: torch.Tensor | None      # (B, 1, H, W) metres; read with input_depth
    k: torch.Tensor                          # (3, 3)
    class_index: torch.Tensor | None = None  # (B,); selects the SE(3) heads of a num_regressors > 1 network
    light: LightParams | None = None         # renders lit at the current pose (ModelNet)

    def to(self, device) -> "Observation":
        return Observation(*(None if x is None else x.to(device) for x in self))

    @staticmethod
    def from_batch(batch) -> "Observation":
        """The observation of a training batch (engine/train.py TrainBatch)."""
        return Observation(batch.image_observed, batch.mask_observed, batch.mask_gt_observed,
                           batch.depth_observed, batch.k, batch.class_index)


def render_at_pose(meshes: MeshBuffers, pose, k, ecfg: EngineConfig, light: LightParams | None = None,
                   with_stats: bool = False, device="cuda"):
    """Render the batch at `pose` -> (image (B, 3, H, W) RGB [0, 255],
    depth (B, 1, H, W), mask (B, 1, H, W)[, dropped]).  No gradients.

    With `light` and mesh normals the vertex colours are lit at `pose`
    (render/lighting.py), so their face corners are expanded anew; with
    ecfg.texture_sampling, uv and textures and no light, the texture is
    sampled per pixel (rasterize_textured)."""
    dev = resolve_device(device)
    with tracing.span("render", dev):
        meshes = meshes.to(dev)
        pose, k = pose.to(dev), k.to(dev)
        colors, corner_colors = meshes.colors, meshes.corner_colors
        with torch.no_grad():
            if light is not None and meshes.normals is not None:
                light = light.to(dev)
                colors = lit_vertex_colors(meshes.vertices, meshes.normals, meshes.colors, pose,
                                           light.position, light.intensity, light.brightness_ratio)
                corner_colors = gather_corners(colors, meshes.faces)
            if (ecfg.texture_sampling and meshes.uv is not None and meshes.textures is not None
                    and light is None):
                rgb, depth, dropped = rasterize_textured(
                    meshes.vertices, meshes.uv, meshes.textures, meshes.faces, meshes.face_valid, pose, k,
                    ecfg.raster, with_stats=True, device=dev,
                )
            else:
                rgb, depth, dropped = rasterize(
                    meshes.vertices, colors, meshes.faces, meshes.face_valid, pose, k, ecfg.raster,
                    corners=meshes.corners, corner_colors=corner_colors, with_stats=True, device=dev,
                )
        rgb = rgb.permute(0, 3, 1, 2)
        depth = depth[:, None]
        mask = render_mask(depth, ecfg.mask_thresh)
    if with_stats:
        return rgb, depth, mask, dropped
    return rgb, depth, mask


def refine_step(model, obs: Observation, meshes: MeshBuffers, pose, ecfg: EngineConfig,
                iter_index: int | None = None, mask_observed_state=None, device="cuda"):
    """One render -> zoom -> match -> update iteration.  Differentiable
    with respect to the model's parameters (the training losses call it
    with autograd on); the render and the zoom crop carry no gradient.
    `mask_observed_state` is the observed mask carried between iterations
    under update_mask='box_observed' (refine passes the previous
    iteration's 'mask_pred_full'); None boxes the loader's mask.

    Returns (pose_new (B, 3, 4), aux dict with the network outputs, the zoom
    factor, the rendered buffers, 'raster_dropped' and, when the network has
    a mask head, 'mask_pred_full': its sigmoid mask inverse-zoomed to the
    full frame and binarised)."""
    _check_supported(ecfg)
    dev = resolve_device(device)
    obs, meshes, pose = obs.to(dev), meshes.to(dev), pose.to(dev)
    k = obs.k
    pm = torch.tensor(ecfg.pixel_means, dtype=torch.float32, device=dev)
    t_means = torch.tensor(ecfg.trans_means, dtype=torch.float32, device=dev)
    t_stds = torch.tensor(ecfg.trans_stds, dtype=torch.float32, device=dev)

    image_rendered, depth_rendered, mask_rendered, dropped = render_at_pose(
        meshes, pose, k, ecfg, obs.light, with_stats=True, device=dev
    )
    if ecfg.update_mask == "box_rendered":
        mask_obs = box_fill(mask_rendered)
        if ecfg.init_mask_host and iter_index == 0:
            mask_obs = obs.mask_observed
    elif ecfg.update_mask == "box_observed":
        carried = obs.mask_observed if mask_observed_state is None else mask_observed_state.to(dev)
        mask_obs = box_fill(carried)
    else:
        mask_obs = obs.mask_observed
    mask_gt_obs = obs.mask_gt_observed if obs.mask_gt_observed is not None else mask_obs

    with tracing.span("zoom", dev):
        zdt = _ZOOM_DTYPES[ecfg.zoom_dtype]
        img_obs_norm = obs.image_observed - pm.reshape(1, 3, 1, 1)
        img_rend_norm = image_rendered - pm.reshape(1, 3, 1, 1)
        if ecfg.input_mask:
            zf = zoom_factor_from_masks(mask_obs, mask_gt_obs, mask_rendered, pose, k)
        else:
            zf = zoom_factor_from_images(img_obs_norm, img_rend_norm, pose, k, pm)
        z_img_obs, z_img_rend = zoom_images(img_obs_norm.to(zdt), img_rend_norm.to(zdt), zf, pm)

        inputs = {}
        z_mask_gt = None
        if ecfg.input_mask:
            z_mask_obs, z_mask_gt, z_mask_rend = zoom_masks(mask_obs, mask_gt_obs, mask_rendered, zf)
            inputs.update(mask_observed=z_mask_obs, mask_rendered=z_mask_rend)
        if ecfg.input_depth:
            z_d_obs, z_d_rend = zoom_depths(obs.depth_observed, depth_rendered, zf)
            scale = 255.0 / ecfg.depth_factor_for_input
            inputs.update(depth_observed=z_d_obs * scale, depth_rendered=z_d_rend * scale)
        x = assemble_input(z_img_obs, z_img_rend, **inputs)
    with tracing.span("net.forward", dev):
        if getattr(model, "num_regressors", 1) > 1:
            out = model(x, obs.class_index)
        else:
            out = model(x)
    with tracing.span("pose.update", dev):
        trans = zoom_trans(out["trans"], zf.as_array(), True, False)
        pose_new = RT_transform(pose, out["rot"], trans, t_means, t_stds, ecfg.rot_coord)
        mask_pred_full = None
        if "mask_logit" in out:
            mask_prob = torch.sigmoid(out["mask_logit"])
            mask_pred_full = torch.round(zoom_mask(mask_prob, zf, binarize_input=True, inverse=True))
    aux = {
        "net": out,
        "mask_pred_full": mask_pred_full,
        "raster_dropped": dropped,
        "rot": out["rot"],
        "trans": trans,
        "zoom_trans": out["trans"],
        "zoom_factor": zf,
        "image_rendered": image_rendered,
        "depth_rendered": depth_rendered,
        "mask_rendered": mask_rendered,
        "zoom_mask_gt_observed": z_mask_gt,
        "zoom_image_observed": z_img_obs,
        "zoom_image_rendered": z_img_rend,
    }
    return pose_new, aux


def refine(model, obs: Observation, meshes: MeshBuffers, pose0, ecfg: EngineConfig,
           num_iters: int | None = None, with_stats: bool = False, device="cuda"):
    """Iterative test-time refinement (no gradients).  Returns (pose_final
    (B, 3, 4), poses (num_iters, B, 3, 4)) and, with `with_stats`, a dict
    {'raster_dropped': summed CSR truncated pairs over all iterations}.
    Under update_mask='box_observed' each iteration's predicted full-frame
    mask becomes the next one's observed mask."""
    n = num_iters if num_iters is not None else ecfg.num_iters
    dev = resolve_device(device)
    with tracing.span("refine.call", dev):
        obs, meshes, pose = obs.to(dev), meshes.to(dev), pose0.to(dev)
        poses, drops = [], []
        mask_state = None
        with torch.no_grad():
            for it in range(n):
                with tracing.span("refine.iter", dev):
                    pose, aux = refine_step(model, obs, meshes, pose, ecfg, iter_index=it,
                                            mask_observed_state=mask_state, device=dev)
                    if ecfg.update_mask == "box_observed" and aux["mask_pred_full"] is not None:
                        mask_state = aux["mask_pred_full"]
                    poses.append(pose)
                    drops.append(aux["raster_dropped"])
        stacked = torch.stack(poses)
        if with_stats:
            return pose, stacked, {"raster_dropped": torch.stack(drops).sum()}
        return pose, stacked
