"""Synthetic refinement scenes: the port's copy of the JAX package's scene
builder (__graft_entry__._build_scene), with the same meshes, seeds and
raster settings.

mesh_detail is the icosphere subdivision level: 2 (a 0.08 m cube and a
320-face ico2, the dense-kernel scene), 4 (~5k faces), 5 (20,480 faces,
LINEMOD-scale, the CSR-kernel scene) or 6 (~82k faces).  At
mesh_detail >= 4 the CSR budget is 4 tiles per face plus the pack spread
per unit, faces are backface-culled (the icospheres are closed and wound
to negative screen area) and the raster runs in sub-batches of 8.
mesh_kind='mixed' uses heavy-tailed meshes with a tuned, tiered budget.
train_batch turns a scene into a TrainBatch (observation at pose_gt,
source pose pose0).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
from scipy.spatial.transform import Rotation

from deepim_tpu_torch.config import DEFAULT_K
from deepim_tpu_torch.device import resolve_device
from deepim_tpu_torch.engine.refine import EngineConfig, MeshBuffers, render_at_pose, tune_raster_for_bank
from deepim_tpu_torch.engine.train import TrainBatch
from deepim_tpu_torch.ops.masks import box_fill
from deepim_tpu_torch.render.mesh import MeshBank, make_icosphere, make_mixed_detail_mesh, make_test_cube
from deepim_tpu_torch.render.rasterizer import RasterConfig, _csr_pack_for

# LINEMOD camera intrinsics (the 480x640 scenes).
LINEMOD_K = np.array(DEFAULT_K, np.float32)


@dataclasses.dataclass
class Scene:
    ecfg: EngineConfig
    bank_arrays: dict        # numpy per-class arrays (MeshBank.arrays())
    cls_idx: np.ndarray      # (B,) class per sample
    meshes: MeshBuffers      # on the scene's device
    pose_gt: np.ndarray      # (B, 3, 4) float32
    pose0: np.ndarray        # (B, 3, 4) float32, 5 cm behind pose_gt
    image: torch.Tensor      # (B, 3, H, W) render at pose_gt
    depth: torch.Tensor      # (B, 1, H, W)
    mask: torch.Tensor       # (B, 1, H, W)
    num_vertices: np.ndarray | None = None  # (B,) real vertices of each sample's mesh


def build_scene(b: int, h: int, w: int, k_mat, num_iters: int, update_mask: str = "box_rendered",
                mesh_detail: int = 2, max_faces_per_tile: int = 128, active_tiles: int = 64,
                pairs_per_face: int = 0, mesh_kind: str = "ico", device="cuda") -> Scene:
    """Build the scene and render its observation at the ground-truth
    poses.  pairs_per_face: CSR per-face tile budget (0 = 4 at
    mesh_detail >= 4)."""
    dev = resolve_device(device)
    ecfg = EngineConfig(
        height=h,
        width=w,
        raster=RasterConfig(
            height=h, width=w,
            tile_h=8 if h % 8 == 0 else 16,
            tile_w=128 if w % 128 == 0 else 16,
            max_faces_per_tile=max_faces_per_tile, chunk=32, znear=0.05, zfar=10.0,
            active_tiles=active_tiles, use_pallas=True,
        ),
        update_mask=update_mask,
        num_iters=num_iters,
    )
    if mesh_kind == "mixed":
        mesh_list = [make_mixed_detail_mesh(0), make_mixed_detail_mesh(1)]
        mesh_detail = 5
        pairs_per_face = -1
    elif mesh_detail <= 2:
        mesh_list = [make_test_cube(0.08), make_icosphere(0.05, 2)]
    else:
        mesh_list = [make_icosphere(0.05, mesh_detail), make_icosphere(0.06, mesh_detail)]
    bank = MeshBank.from_meshes(mesh_list, pad_multiple=128)
    bank_arrays = bank.arrays()
    s_per_face = pairs_per_face if pairs_per_face else (4 if mesh_detail >= 4 else 0)
    if s_per_face:
        f_padded = int(bank.faces.shape[1])
        pack = _csr_pack_for(ecfg.raster, f_padded)
        if s_per_face < 0:
            ecfg = tune_raster_for_bank(ecfg, bank_arrays, k_mat, z_min=0.45)
            bin_pairs = ecfg.raster.bin_pairs
        else:
            bin_pairs = (f_padded // pack) * (s_per_face + (pack if pack > 1 else 0))
        ecfg = dataclasses.replace(
            ecfg,
            raster=dataclasses.replace(
                ecfg.raster,
                bin_pairs=bin_pairs,
                **({} if mesh_detail <= 2 else dict(backface_cull=-1, raster_batch_chunk=8)),
            ),
        )
    cls_idx = np.arange(b) % 2
    meshes = MeshBuffers.gather(bank_arrays, cls_idx, device=dev)
    rng = np.random.RandomState(0)
    rot = Rotation.from_euler("xyz", rng.uniform(-0.4, 0.4, (b, 3))).as_matrix().astype(np.float32)
    pose_gt = np.concatenate([rot, np.zeros((b, 3, 1), np.float32)], 2)
    pose_gt[:, 0, 3] = rng.uniform(-0.02, 0.02, b)
    pose_gt[:, 1, 3] = rng.uniform(-0.02, 0.02, b)
    pose_gt[:, 2, 3] = 0.6
    pose0 = pose_gt.copy()
    pose0[:, 2, 3] += 0.05
    img, depth, mask = render_at_pose(
        meshes, torch.from_numpy(pose_gt), torch.from_numpy(np.asarray(k_mat, np.float32)),
        ecfg, device=dev,
    )
    return Scene(ecfg, bank_arrays, cls_idx, meshes, pose_gt, pose0, img, depth, mask,
                 bank.num_vertices[cls_idx])


def train_batch(scene: Scene, k_mat, num_3d_sample: int) -> TrainBatch:
    """The scene as one training batch, on the scene's device: box-filled
    observed mask, the rendered mask as gt mask, its depth as gt and as
    observed depth (the input_depth channels), pose0 as source and pose_gt
    as target pose.  points_model is each
    mesh's first num_3d_sample vertices, zero-padded with weight 0."""
    dev = scene.image.device
    b = scene.image.shape[0]
    n_v = scene.meshes.vertices.shape[1]
    n = min(num_3d_sample, n_v)
    points = torch.zeros((b, num_3d_sample, 3), dtype=torch.float32, device=dev)
    points[:, :n] = scene.meshes.vertices[:, :n]
    weights = (np.arange(num_3d_sample)[None, :] < np.minimum(scene.num_vertices, n)[:, None])
    weights = torch.from_numpy(weights.astype(np.float32)).to(dev)
    points = points * weights[..., None]
    return TrainBatch(
        image_observed=scene.image,
        mask_observed=box_fill(scene.mask),
        mask_gt_observed=scene.mask,
        depth_gt_observed=scene.depth[:, 0],
        pose_rendered=torch.from_numpy(scene.pose0).to(dev),
        pose_observed=torch.from_numpy(scene.pose_gt).to(dev),
        class_index=torch.from_numpy(scene.cls_idx).to(dev),
        points_model=points,
        points_weights=weights,
        k=torch.from_numpy(np.asarray(k_mat, np.float32)).to(dev),
        depth_observed=scene.depth,
    )
