"""The port's numpy PnP-RANSAC flow2se3 (deepim_tpu_torch/ops/flow2se3.py)
against the JAX package's, which calls cv2.solvePnPRansac, on the CPU.

RANSAC's draws cannot be cv2's, so the poses are compared, with these
tolerances: the converged flags equal; on consistent flow the two poses
within 0.05 deg and 0.1 mm of each other (both reach the least-squares
pose of the same inliers); with 20% outlier flow each within 0.5 deg and
2 mm of the truth; under 6 valid points the identity exactly."""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation as R

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from deepim_tpu.ops.flow2se3 import flow2se3 as j_flow2se3  # noqa: E402
from deepim_tpu_torch.ops import flow2se3 as tf  # noqa: E402

torch.set_num_threads(2)

H, W = 96, 128
K = np.array([[120.0, 0, 64], [0, 120.0, 48], [0, 0, 1]], np.float32)


def _angle_deg(q1, q2) -> float:
    return float(np.degrees(2 * np.arccos(min(abs(float(np.dot(q1, q2))), 1.0))))


def _quat(rot) -> np.ndarray:
    q = R.from_matrix(rot).as_quat()[[3, 0, 1, 2]]
    return q if q[0] >= 0 else -q


def _plane_case():
    """tests/test_mesh_io.py's case: a plane at 0.5 m with under 1 cm of
    relief, every pixel moved 4 px right, the mask 4 px right of the
    depth."""
    depth = np.zeros((H, W), np.float32)
    ys, xs = np.mgrid[20:76, 30:98]
    depth[20:76, 30:98] = 0.5 + 0.001 * ((xs % 7) + (ys % 5))
    flow = np.zeros((H, W, 2), np.float32)
    flow[..., 0] = 4.0
    mask = np.zeros((H, W), np.float32)
    mask[20:76, 34:102] = 1
    return depth, flow, mask


def _surface_case(outliers: float, seed: int = 0):
    """A curved surface at 0.6 m seen through an ellipse, moved by a known
    rotation and translation; its exact flow, then a fraction `outliers`
    of the pixels' flow pushed 20-40 px off in a random direction.
    Returns (depth, flow, mask, rotation, translation)."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:H, 0:W]
    inside = ((xx - 64) ** 2 / 40 ** 2 + (yy - 48) ** 2 / 30 ** 2) < 1
    depth = np.zeros((H, W), np.float32)
    depth[inside] = (0.6 + 0.03 * np.sin(xx / 6.0) * np.cos(yy / 5.0) + 0.0005 * (xx - 64))[inside]
    rot = R.from_euler("xyz", [0.05, -0.08, 0.1]).as_matrix()
    trans = np.array([0.01, -0.015, 0.03])
    k64 = K.astype(np.float64)
    pix = np.stack([xx.ravel(), yy.ravel(), np.ones(H * W)])
    pts = ((np.linalg.inv(k64) @ pix) * depth.reshape(1, -1)).T
    proj = (pts @ rot.T + trans) @ k64.T
    flow = (proj[:, :2] / proj[:, 2:3] - pix[:2].T).reshape(H, W, 2).astype(np.float32)
    bad = rng.rand(H, W) < outliers
    ang = rng.uniform(0, 2 * np.pi, bad.sum())
    flow[bad] += (rng.uniform(20, 40, bad.sum())[:, None] * np.stack([np.cos(ang), np.sin(ang)], 1)).astype(
        np.float32)
    return depth, flow, (depth > 0).astype(np.float32), rot, trans


def _agree(a, b, deg: float, metres: float) -> None:
    assert a[0] == b[0]
    assert _angle_deg(a[1][:4], b[1][:4]) <= deg
    assert np.abs(a[1][4:] - b[1][4:]).max() <= metres


def test_flow2se3_plane_matches_cv2():
    """The near-planar case, where a DLT alone is ill-conditioned: both
    converge to the same pose (and recover the +x shift)."""
    depth, flow, mask = _plane_case()
    j = j_flow2se3(depth, flow, mask, K)
    t = tf.flow2se3(depth, flow, mask, K, rng=0)
    assert t[0] and t[1][0] > 0.99 and abs(t[1][4] - 4.0 * 0.5 / 120.0) < 0.01
    _agree(t, j, 0.05, 1e-4)


def test_flow2se3_clean_surface_matches_cv2():
    """A rotated and translated curved surface with consistent flow: both
    at the same pose, which is the truth."""
    depth, flow, mask, rot, trans = _surface_case(0.0)
    j = j_flow2se3(depth, flow, mask, K)
    t = tf.flow2se3(depth, flow, mask, K, rng=1)
    _agree(t, j, 0.05, 1e-4)
    _agree(t, (True, np.concatenate([_quat(rot), trans])), 0.05, 1e-4)


@pytest.mark.parametrize("seed", [0, 1])
def test_flow2se3_outliers_recover_truth(seed):
    """20% of the flow off by 20-40 px: both converge, each within 0.5 deg
    and 2 mm of the truth."""
    depth, flow, mask, rot, trans = _surface_case(0.2, seed)
    truth = (True, np.concatenate([_quat(rot), trans]))
    j = j_flow2se3(depth, flow, mask, K)
    t = tf.flow2se3(depth, flow, mask, K, rng=seed)
    assert j[0] and t[0]
    _agree(j, truth, 0.5, 2e-3)
    _agree(t, truth, 0.5, 2e-3)


def test_flow2se3_under_six_points_is_identity():
    """Five valid pixels: (False, identity) exactly, as JAX returns."""
    depth, flow, mask, _, _ = _surface_case(0.0)
    few = np.zeros_like(mask)
    few[40, 60:65] = 1
    j = j_flow2se3(depth, flow, few, K)
    t = tf.flow2se3(depth, flow, few, K)
    assert t[0] is False and j[0] is False
    np.testing.assert_array_equal(t[1], np.array([1.0, 0, 0, 0, 0, 0, 0]))
    np.testing.assert_array_equal(t[1], j[1])


def test_flow2se3_seed_decides_the_draws():
    """The same seed gives the same pose bit for bit, a Generator is taken
    as a seed is; the result does not hang on the draws beyond rounding."""
    depth, flow, mask, _, _ = _surface_case(0.2, 3)
    a = tf.flow2se3(depth, flow, mask, K, rng=5)
    b = tf.flow2se3(depth, flow, mask, K, rng=np.random.default_rng(5))
    c = tf.flow2se3(depth, flow, mask, K, rng=6)
    np.testing.assert_array_equal(a[1], b[1])
    _agree(a, c, 1e-3, 1e-6)


def test_pnp_ransac_early_stop_follows_cv2_rule():
    """RANSACUpdateNumIters: with no outliers one draw suffices; at 20%
    outliers and 6-point draws, 0.99 confidence needs 15 (15.15 rounded); a
    cap is never exceeded."""
    assert tf._update_iterations(0.99, 0.0, 6, 100) == 0
    assert tf._update_iterations(0.99, 0.2, 6, 100) == 15
    assert tf._update_iterations(0.99, 0.9, 6, 100) == 100
