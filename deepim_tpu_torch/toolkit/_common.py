"""Shared helpers of the data-preparation toolkit (counterpart of
deepim_tpu/toolkit/_common.py): devkit paths, pose files with the
class-index header, the batched pose-list renderer and the PNG writers.

BatchRenderer renders through render/rasterizer.py:rasterize with the JAX
renderer's RasterConfig (height, width, znear, zfar, every other field at
its default), so its renders are JAX's, holes included.  PNGs are written
with utils/png.py, every row Sub filtered (tools/synth_data.py's rule):
the files decode to what the JAX toolkit's cv2 writes decode to, and the
port's loaders decode Sub rows at whole-row speed.
"""
from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np
import torch

from deepim_tpu_torch.data.pairdb import LM_IDX2CLASS
from deepim_tpu_torch.device import resolve_device
from deepim_tpu_torch.render.lighting import lit_vertex_colors
from deepim_tpu_torch.render.mesh import load_textured_mesh
from deepim_tpu_torch.render.rasterizer import RasterConfig, gather_corners, rasterize
from deepim_tpu_torch.utils.png import write_png

DEFAULT_K = np.array(
    [[572.4114, 0.0, 325.2611], [0.0, 573.57043, 242.04899], [0.0, 0.0, 1.0]], np.float32
)
WIDTH, HEIGHT = 640, 480
ZNEAR, ZFAR = 0.25, 6.0
DEPTH_FACTOR = 1000.0
PNG_FILTER = 1  # Sub


@dataclass
class Devkit:
    """Paths of an LM6d_refine-layout devkit (toolkit/LM6d_*.py globals)."""

    root: str

    @property
    def observed_set_dir(self):
        return os.path.join(self.root, "image_set", "observed")

    @property
    def pair_set_dir(self):
        return os.path.join(self.root, "image_set")

    @property
    def observed_dir(self):
        return os.path.join(self.root, "data", "observed")

    @property
    def gt_observed_dir(self):
        return os.path.join(self.root, "data", "gt_observed")

    @property
    def rendered_dir(self):
        return os.path.join(self.root, "data", "rendered")

    @property
    def rendered_pose_dir(self):
        return os.path.join(self.root, "rendered_poses")

    @property
    def models_dir(self):
        return os.path.join(self.root, "models")

    def observed_indices(self, cls_name: str, image_set: str = "all") -> list[str]:
        path = os.path.join(self.observed_set_dir, f"{cls_name}_{image_set}.txt")
        with open(path) as f:
            return [x.strip() for x in f if x.strip()]


def resolve_classes(classes: list[str] | None) -> dict[int, str]:
    """CLI --classes filter over the LINEMOD table (LM6d_*.py idx2class); a
    name outside the table gets index i + 1, its place in `classes`."""
    if not classes:
        return dict(LM_IDX2CLASS)
    name2idx = {v: k for k, v in LM_IDX2CLASS.items()}
    out = {}
    for i, c in enumerate(classes):
        out[name2idx.get(c, i + 1)] = c
    return out


def write_pose_file_with_class(path: str, class_idx: int, pose: np.ndarray) -> None:
    """-pose.txt with the class index as the header line
    (LM6d_0_gen_gt_observed.py write_pose_file)."""
    pose = np.asarray(pose).reshape(3, 4)
    with open(path, "w") as f:
        f.write(f"{class_idx}\n")
        f.write("\n".join(" ".join(str(v) for v in row) for row in pose))


def load_observed_pose(dk: Devkit, cls_name: str, cls_idx: int, observed_idx: str) -> np.ndarray:
    """GT pose of `cls` in an observed frame.  Prefers the reference's
    -meta.mat (cls_indexes + poses, LM6d_0_gen_gt_observed.py:110-117), falls
    back to an adapted gt_observed/<cls>/<prefix>-pose.txt."""
    prefix = observed_idx.split("/")[-1]
    meta_path = os.path.join(dk.observed_dir, f"{observed_idx}-meta.mat")
    if os.path.exists(meta_path):
        import scipy.io as sio

        meta = sio.loadmat(meta_path)
        if meta["poses"].ndim == 2:
            return np.asarray(meta["poses"], np.float64).reshape(3, 4)
        inner = np.where(np.atleast_1d(np.squeeze(meta["cls_indexes"])) == cls_idx)
        return np.squeeze(meta["poses"][:, :, inner]).reshape(3, 4)
    pose_path = os.path.join(dk.gt_observed_dir, cls_name, f"{prefix}-pose.txt")
    return np.loadtxt(pose_path, skiprows=1).reshape(3, 4)


class BatchRenderer:
    """Batched pose-list renderer on the port's rasterizer.

    One model's vertices, colours, faces, normals and corner arrays sit on
    the device, tiled to `batch`, built once.  Poses are rendered `batch`
    at a time, one rasterize call each; the last batch is padded with its
    last pose, so every call has the same shape and a list of n poses
    takes ceil(n / batch) calls."""

    def __init__(self, model_dir: str, k: np.ndarray = DEFAULT_K,
                 width: int = WIDTH, height: int = HEIGHT,
                 znear: float = ZNEAR, zfar: float = ZFAR, batch: int = 8,
                 raster_cfg: RasterConfig | None = None, device="cuda"):
        self.device = dev = resolve_device(device)
        mesh = load_textured_mesh(model_dir)

        def tiled(a, dtype):
            return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(dev)[None].repeat(
                (batch,) + (1,) * np.ndim(a))

        self._verts = tiled(mesh.vertices, np.float32)
        self._cols = tiled(mesh.colors, np.float32)
        self._faces = tiled(mesh.faces, np.int32)
        self._normals = tiled(mesh.vertex_normals(), np.float32)
        self._fvalid = torch.ones((batch, mesh.num_faces), dtype=torch.bool, device=dev)
        self._corners = gather_corners(self._verts, self._faces)
        self._corner_cols = gather_corners(self._cols, self._faces)
        self._k = torch.from_numpy(np.asarray(k, np.float32)).to(dev)
        self.batch = batch
        self.cfg = raster_cfg or RasterConfig(height=height, width=width, znear=znear, zfar=zfar)

    def _pad(self, x: np.ndarray) -> torch.Tensor:
        """A chunk of at most `batch` rows, padded with its last row."""
        x = np.asarray(x, np.float32)
        if x.shape[0] < self.batch:
            x = np.concatenate([x, np.repeat(x[-1:], self.batch - x.shape[0], axis=0)])
        return torch.from_numpy(x).to(self.device)

    def _render_batch(self, poses: torch.Tensor, corner_colors: torch.Tensor) -> tuple[np.ndarray, np.ndarray]:
        """One rasterize call -> numpy rgb (B, H, W, 3), depth (B, H, W)."""
        rgb, depth = rasterize(self._verts, self._cols, self._faces, self._fvalid, poses, self._k, self.cfg,
                               corners=self._corners, corner_colors=corner_colors, device=self.device)
        return rgb.cpu().numpy(), depth.cpu().numpy()

    def render_many(self, poses: np.ndarray):
        """poses (N, 3, 4) -> yields (rgb (H,W,3) uint8-range float, depth
        (H,W) meters) per pose, rendered in device batches."""
        poses = np.asarray(poses, np.float32).reshape(-1, 3, 4)
        n = poses.shape[0]
        for start in range(0, n, self.batch):
            rgb, depth = self._render_batch(self._pad(poses[start:start + self.batch]), self._corner_cols)
            for j in range(min(self.batch, n - start)):
                yield rgb[j], depth[j]

    def render_many_lit(self, poses: np.ndarray, light_pos: np.ndarray, light_int: np.ndarray,
                        brightness_k: np.ndarray):
        """Point-light variant (render/lighting.py): per-pose light
        position/intensity (N, 3) and brightness ratio (N,)."""
        poses = np.asarray(poses, np.float32).reshape(-1, 3, 4)
        n = poses.shape[0]
        for start in range(0, n, self.batch):
            sl = slice(start, start + self.batch)
            chunk = self._pad(poses[sl])
            cols = lit_vertex_colors(self._verts, self._normals, self._cols, chunk, self._pad(light_pos[sl]),
                                     self._pad(light_int[sl]), self._pad(brightness_k[sl]))
            rgb, depth = self._render_batch(chunk, gather_corners(cols, self._faces))
            for j in range(min(self.batch, n - start)):
                yield rgb[j], depth[j]


def write_color_png(path: str, rgb: np.ndarray) -> None:
    """RGB clipped to [0, 255] and truncated to uint8."""
    write_png(path, np.clip(np.asarray(rgb), 0, 255).astype(np.uint8), PNG_FILTER)


def write_depth_png(path: str, depth: np.ndarray, depth_factor: float = DEPTH_FACTOR) -> None:
    """Depth x depth_factor, truncated to uint16."""
    write_png(path, (np.asarray(depth) * depth_factor).astype(np.uint16), PNG_FILTER)


def write_label_png(path: str, label: np.ndarray) -> None:
    """An 8-bit label image."""
    write_png(path, np.asarray(label, np.uint8), PNG_FILTER)
