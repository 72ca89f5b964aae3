"""The one generator of the benchmark's traffic: poses and classes of a
pool of batches, from a traffic file's parameters and the run's seed.

Traffic parameters (perfbench/traffic/<name>.json):
  kind        the driver that runs it ("refine", "train")
  batch       samples a call (train: omitted, the config's TRAIN.BATCH_PAIRS)
  pool        distinct batches made at set-up and cycled through the window
  z_m         [near, far] object depth; each batch's depths are stratified
              over the range (one per 1/batch slice), so every seed renders
              the same spread of sizes, in another order
  center_px   [[u_lo, u_hi], [v_lo, v_hi]]: the projected object centre
  classes     "uniform": each class as often over the pool (the remainder
              going to the lowest class ids), shuffled
  perturb     {"rot_std_deg", "rot_max_deg", "trans_std_m"}: the initial
              pose, sample_perturbed_pose's noise model
plus what the driver reads itself (iterations, compared calls or steps).
Ground-truth rotations are uniform over SO(3).
"""
from __future__ import annotations

import numpy as np
from scipy.spatial.transform import Rotation


def sample_perturbed_pose(pose: np.ndarray, rng, rot_std_deg: float, rot_max_deg: float, trans_std) -> np.ndarray:
    """Frozen copy of deepim_tpu_torch/tools/synth_data.sample_perturbed_pose:
    per-axis Euler noise N(0, rot_std_deg) clipped at rot_max_deg, applied
    on the left, and translation noise N(0, trans_std) m."""
    ang = np.clip(rng.normal(0, rot_std_deg, 3), -rot_max_deg, rot_max_deg)
    r_noise = Rotation.from_euler("xyz", ang, degrees=True).as_matrix()
    t_noise = rng.normal(0, trans_std, 3)
    out = pose.copy().astype(np.float32)
    out[:, :3] = r_noise @ pose[:, :3]
    out[:, 3] = pose[:, 3] + t_noise
    return out


def make_pool(traffic: dict, batch: int, num_classes: int, k: np.ndarray, seed: int) -> list[dict]:
    """`pool` batches of {'class_index' (B,), 'pose_gt' (B, 3, 4),
    'pose0' (B, 3, 4)} as float32 / int64 numpy arrays."""
    rng = np.random.default_rng([seed, 2])
    n_pool = traffic["pool"]
    n = n_pool * batch
    if traffic.get("classes", "uniform") != "uniform":
        raise ValueError(f"unknown class mix {traffic['classes']!r}")
    classes = np.resize(np.arange(num_classes), n)
    rng.shuffle(classes)
    (u_lo, u_hi), (v_lo, v_hi) = traffic["center_px"]
    z_lo, z_hi = traffic["z_m"]
    pert = traffic["perturb"]
    pool = []
    for p in range(n_pool):
        z = z_lo + (rng.permutation(batch) + rng.uniform(size=batch)) / batch * (z_hi - z_lo)
        u, v = rng.uniform(u_lo, u_hi, batch), rng.uniform(v_lo, v_hi, batch)
        t = np.stack([(u - k[0, 2]) * z / k[0, 0], (v - k[1, 2]) * z / k[1, 1], z], -1)
        rot = Rotation.random(batch, random_state=rng).as_matrix()
        gt = np.concatenate([rot, t[:, :, None]], -1).astype(np.float32)
        pose0 = np.stack([sample_perturbed_pose(g, rng, pert["rot_std_deg"], pert["rot_max_deg"],
                                                pert["trans_std_m"]) for g in gt])
        pool.append({"class_index": classes[p * batch:(p + 1) * batch].astype(np.int64),
                     "pose_gt": gt, "pose0": pose0.astype(np.float32)})
    return pool
