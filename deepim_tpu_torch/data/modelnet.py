"""Unseen-object (ModelNet-style) pair database (counterpart of
deepim_tpu/data/modelnet.py): class-agnostic refinement on CAD models
never seen in training.

* `model_file`: one mesh path per line (.obj, vertex-coloured or textured).
* `pose_file`: one sample per line, `<model_idx> r00 r01 ... t2` (12
  floats, row-major [R|t]).  The observed frame is rendered at that pose
  under a random point light, and the initial pose is the gt perturbed by
  the standard noise model (tools/synth_data.sample_perturbed_pose).

The matching network is class-agnostic (REGRESSOR_NUM=1), so testing on
ModelNet loads a bank of novel meshes with vertex normals and runs the
same refinement with lit renders (tools/test_net.test_modelnet).
"""
from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np

from deepim_tpu_torch.render.mesh import Mesh, MeshBank, load_textured_mesh
from deepim_tpu_torch.tools.synth_data import sample_perturbed_pose


def load_model_list(model_file: str) -> list[str]:
    with open(model_file) as f:
        return [line.strip() for line in f if line.strip()]


def load_pose_list(pose_file: str) -> tuple[np.ndarray, np.ndarray]:
    """Returns (model indices (N,) int32, poses (N, 3, 4) float32)."""
    idx, poses = [], []
    with open(pose_file) as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            idx.append(int(parts[0]))
            poses.append(np.asarray([float(x) for x in parts[1:13]], np.float32).reshape(3, 4))
    return np.asarray(idx, np.int32), np.stack(poses)


@dataclass
class ModelNetDB:
    """Unseen-object pair database backed by model and pose list files."""

    model_file: str
    pose_file: str
    seed: int = 0

    def __post_init__(self):
        self.model_paths = load_model_list(self.model_file)
        self.model_idx, self.poses_gt = load_pose_list(self.pose_file)
        if self.model_idx.max() >= len(self.model_paths):
            raise ValueError(f"{self.pose_file} names model {self.model_idx.max()} but "
                             f"{self.model_file} lists {len(self.model_paths)}")
        self._meshes: list[Mesh] | None = None

    def meshes(self) -> list[Mesh]:
        if self._meshes is None:
            self._meshes = [load_textured_mesh(os.path.dirname(p), obj_name=os.path.basename(p))
                            for p in self.model_paths]
        return self._meshes

    def mesh_bank(self) -> MeshBank:
        meshes = self.meshes()
        return MeshBank.from_meshes(meshes).with_normals(meshes)

    def sample_records(self, rng: np.random.RandomState | None = None) -> list[dict]:
        """One record a pose line: the gt pose, the perturbed initial pose
        and a random light (position about 0.5 m in front of the camera,
        intensity 0.8-1.2 a channel, brightness ratio 0.4, 0.3 or 0.2),
        drawn from `rng` (default RandomState(seed)) in that order."""
        rng = rng or np.random.RandomState(self.seed)
        records = []
        for i in range(len(self.model_idx)):
            pose_gt = self.poses_gt[i]
            records.append({
                "model_index": int(self.model_idx[i]),
                "pose_observed": pose_gt,
                "pose_rendered": sample_perturbed_pose(pose_gt, rng),
                "light_position": rng.uniform(-0.5, 0.5, 3).astype(np.float32)
                + np.array([0, 0, -0.5], np.float32),
                "light_intensity": rng.uniform(0.8, 1.2, 3).astype(np.float32),
                "brightness_ratio": np.float32(rng.choice([0.4, 0.3, 0.2])),
            })
        return records


def write_modelnet_lists(out_dir: str, mesh_paths: list[str], poses: list[tuple[int, np.ndarray]]):
    """Write models.txt and poses.txt for `mesh_paths` and (model index,
    (3, 4) pose) pairs into out_dir; returns their paths."""
    os.makedirs(out_dir, exist_ok=True)
    model_file = os.path.join(out_dir, "models.txt")
    pose_file = os.path.join(out_dir, "poses.txt")
    with open(model_file, "w") as f:
        f.write("\n".join(mesh_paths) + "\n")
    with open(pose_file, "w") as f:
        for idx, pose in poses:
            vals = " ".join(f"{v:.8f}" for v in np.asarray(pose).reshape(12))
            f.write(f"{idx} {vals}\n")
    return model_file, pose_file
