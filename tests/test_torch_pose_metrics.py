"""Parity of the port's rotation and projection tails
(deepim_tpu_torch/geometry/rotations.py, projection.py) and pose metrics
(geometry/pose_metrics.py) with the JAX package's, on the CPU, and of the
metrics with the port's float64 host evaluator (eval/evaluator.py).

Tolerances: float32 against JAX atol 1e-6 plus rtol 2^-22, two float32
ulps of the value: degrees up to 180 and pixels of ~50 carry ulps of up to
1.5e-5, and the packages' arccos and 3x3 products round their last bit
apart (the geodesic's trace is rounded as XLA rounds it, see
geometry/rotations.py, or one ulp of the cosine would cost 1e-5 deg at a
few degrees).  Float64 metrics against the evaluator rtol 1e-9; float32
metrics against it rtol 1e-4 (chip_smoke phase 17's rule)."""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation as R

import jax.numpy as jnp

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

import deepim_tpu.geometry as j_geometry  # noqa: E402
from deepim_tpu.geometry import pose_metrics as jpm  # noqa: E402
from deepim_tpu.geometry import projection as jproj  # noqa: E402
from deepim_tpu.geometry import rotations as jrot  # noqa: E402
import deepim_tpu_torch.geometry as t_geometry  # noqa: E402
from deepim_tpu_torch.eval import evaluator as ev  # noqa: E402
from deepim_tpu_torch.geometry import pose_metrics as tpm  # noqa: E402
from deepim_tpu_torch.geometry import projection as tproj  # noqa: E402
from deepim_tpu_torch.geometry import rotations as trot  # noqa: E402

torch.set_num_threads(2)

K = np.array([[572.4114, 0.0, 325.2611], [0.0, 573.57043, 242.04899], [0.0, 0.0, 1.0]], np.float32)


def _t(x):
    return torch.from_numpy(np.array(x, copy=True))


def _quats(rng, n):
    q = rng.randn(n, 4).astype(np.float32)
    return q / np.linalg.norm(q, axis=1, keepdims=True)


def _pose_pairs(rng, b, near=0.2):
    """b (est, gt) rotation and translation pairs at LINEMOD depths: half
    the estimates within `near` rad and 1 cm of their gt, half anywhere."""
    r_gt = R.random(b, random_state=rng).as_matrix()
    t_gt = np.stack([rng.uniform(-0.1, 0.1, b), rng.uniform(-0.1, 0.1, b), rng.uniform(0.6, 1.2, b)], 1)
    r_est = R.random(b, random_state=rng).as_matrix()
    h = b // 2
    r_est[:h] = (R.from_rotvec(rng.uniform(-near, near, (h, 3))) * R.from_matrix(r_gt[:h])).as_matrix()
    t_est = t_gt + rng.normal(0, 0.01, (b, 3))
    return r_est, t_est, r_gt, t_gt


ULP2 = 2.0 ** -22  # two float32 ulps, relative


def _close(got, ref, name=""):
    np.testing.assert_allclose(got, ref, atol=1e-6, rtol=ULP2, err_msg=name)


# --- rotations --------------------------------------------------------------


def test_qmult_quat_inverse_match_jax(rng):
    """qmult (w >= 0) and quat_inverse (unit and unnormalised, and the
    all-zero quaternion at the 1e-12 floor)."""
    q1, q2 = _quats(rng, 64), _quats(rng, 64)
    np.testing.assert_allclose(trot.qmult(_t(q1), _t(q2)).numpy(), np.asarray(jrot.qmult(q1, q2)), atol=1e-6)
    assert (trot.qmult(_t(q1), _t(q2))[:, 0] >= 0).all()
    q = np.concatenate([q1 * rng.uniform(0.5, 2.0, (64, 1)).astype(np.float32), np.zeros((1, 4), np.float32)])
    np.testing.assert_allclose(trot.quat_inverse(_t(q)).numpy(), np.asarray(jrot.quat_inverse(q)), atol=1e-6)
    ident = trot.qmult(_t(q1), trot.quat_inverse(_t(q1)))
    np.testing.assert_allclose(ident.numpy(), np.tile([1.0, 0, 0, 0], (64, 1)), atol=1e-6)


@pytest.mark.parametrize("pitch", [np.pi / 2, -np.pi / 2])
def test_mat2euler_gimbal_lock_matches_jax(pitch):
    """At pitch +-90 deg (cy at float32 rounding level, under 4 eps) both
    take the degenerate branch: ak = 0 and ai absorbs the roll; the angles
    rebuild the matrix."""
    ai = np.array([0.3, -1.2, 2.0], np.float32)
    ak = np.array([0.7, 0.1, -2.5], np.float32)
    m = np.asarray(jrot.euler2mat(ai, np.full(3, pitch, np.float32), ak))
    cy = np.sqrt(m[:, 0, 0] ** 2 + m[:, 1, 0] ** 2)
    assert (cy <= 4 * np.finfo(np.float32).eps).all()
    got = [x.numpy() for x in trot.mat2euler(_t(m))]
    ref = [np.asarray(x) for x in jrot.mat2euler(m)]
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g, r, atol=1e-6)
    np.testing.assert_array_equal(got[2], np.zeros(3, np.float32))
    back = trot.euler2mat(*(_t(x) for x in got)).numpy()
    np.testing.assert_allclose(back, m, atol=1e-5)


def test_mat2euler_regular_matches_jax(rng):
    m = R.random(128, random_state=rng).as_matrix().astype(np.float32)
    for g, r in zip(trot.mat2euler(_t(m)), jrot.mat2euler(m)):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-6)


def test_rot_geodesic_and_quat_angle_match_jax(rng):
    """Random pairs and pairs up to 0.35 rad apart, as rotations and as
    quaternions."""
    r_est, _, r_gt, _ = _pose_pairs(rng, 64)
    r_est, r_gt = r_est.astype(np.float32), r_gt.astype(np.float32)
    _close(trot.rot_geodesic_deg(_t(r_est), _t(r_gt)).numpy(), np.asarray(jrot.rot_geodesic_deg(r_est, r_gt)))
    q1 = R.from_matrix(r_est).as_quat()[:, [3, 0, 1, 2]].astype(np.float32)
    q2 = R.from_matrix(r_gt).as_quat()[:, [3, 0, 1, 2]].astype(np.float32)
    _close(trot.quat_angle_deg(_t(q1), _t(q2)).numpy(), np.asarray(jrot.quat_angle_deg(q1, q2)))
    same = trot.rot_geodesic_deg(_t(r_gt), _t(r_gt)).numpy()
    assert np.isfinite(same).all() and same.max() < 0.1


def test_geometry_exports_match_jax():
    """The port's geometry package exports every name the JAX package's
    does (its modules and the rotation functions)."""
    j_names = {n for n in vars(j_geometry) if not n.startswith("_")}
    missing = sorted(n for n in j_names if not hasattr(t_geometry, n))
    assert not missing, missing


# --- projection -------------------------------------------------------------


def test_projection_tail_matches_jax(rng):
    depth = np.where(rng.rand(2, 12, 16) > 0.3, rng.uniform(0.4, 1.2, (2, 12, 16)), 0).astype(np.float32)
    k_inv = np.linalg.inv(K).astype(np.float32)
    np.testing.assert_allclose(tproj.backproject_pixels(_t(depth), _t(k_inv)).numpy(),
                               np.asarray(jproj.backproject_pixels(depth, k_inv)), atol=1e-6, rtol=0)
    r_est, t_est, _, _ = _pose_pairs(rng, 4)
    pose = np.concatenate([r_est, t_est[:, :, None]], 2).astype(np.float32)
    pts = rng.uniform(-0.05, 0.05, (4, 30, 3)).astype(np.float32)
    np.testing.assert_allclose(tproj.transform_points(_t(pose), _t(pts)).numpy(),
                               np.asarray(jproj.transform_points(pose, pts)), atol=1e-6, rtol=0)
    _close(tproj.project_pose_center(_t(K), _t(pose)).numpy(), np.asarray(jproj.project_pose_center(K, pose)))


# --- pose metrics -----------------------------------------------------------


def _metric_args(name, r_est, t_est, r_gt, t_gt, pts):
    return {"add": (r_est, t_est, r_gt, t_gt, pts), "adi": (r_est, t_est, r_gt, t_gt, pts),
            "re": (r_est, r_gt), "te": (t_est, t_gt), "arp_2d": (r_est, t_est, r_gt, t_gt, pts, K)}[name]


@pytest.mark.parametrize("name", ["add", "adi", "re", "te", "arp_2d"])
def test_pose_metrics_match_jax(rng, name):
    """Batched over (2, 5) leading dims, 700 model points (adi: a chunk of
    512 and a partial one of 188)."""
    r_est, t_est, r_gt, t_gt = (x.astype(np.float32).reshape((2, 5) + x.shape[1:]) for x in _pose_pairs(rng, 10))
    pts = rng.uniform(-0.05, 0.05, (700, 3)).astype(np.float32)
    args = _metric_args(name, r_est, t_est, r_gt, t_gt, pts)
    got = getattr(tpm, name)(*(_t(a) for a in args)).numpy()
    ref = np.asarray(getattr(jpm, name)(*(jnp.asarray(a) for a in args)))
    assert got.shape == ref.shape == (2, 5) and got.dtype == np.float32
    _close(got, ref, name)


@pytest.mark.parametrize("chunk", [64, 100, 1000])
def test_adi_chunks_match_jax(rng, chunk):
    """ADI with N = 300 model points against chunks that divide it, do not,
    and exceed it: each equals JAX's with the same chunk and the others."""
    r_est, t_est, r_gt, t_gt = (x.astype(np.float32) for x in _pose_pairs(rng, 6))
    pts = rng.uniform(-0.05, 0.05, (300, 3)).astype(np.float32)
    got = tpm.adi(_t(r_est), _t(t_est), _t(r_gt), _t(t_gt), _t(pts), chunk=chunk).numpy()
    ref = np.asarray(jpm.adi(*(jnp.asarray(a) for a in (r_est, t_est, r_gt, t_gt, pts)), chunk=chunk))
    np.testing.assert_allclose(got, ref, atol=1e-6, rtol=0)
    whole = tpm.adi(_t(r_est), _t(t_est), _t(r_gt), _t(t_gt), _t(pts), chunk=300).numpy()
    np.testing.assert_array_equal(got, whole)


@pytest.mark.parametrize("dtype,rtol", [(torch.float64, 1e-9), (torch.float32, 1e-4)])
def test_pose_metrics_match_evaluator(rng, dtype, rtol):
    """add, adi, arp_2d, re and te against the evaluator's float64 host
    functions (_add_errors, _adi_errors by cKDTree, _arp2d_errors,
    _rot_trans_errors) on 64 pose pairs of a 1,000-point model."""
    r_est, t_est, r_gt, t_gt = _pose_pairs(rng, 64)
    pts = rng.uniform(-0.05, 0.05, (1000, 3))
    est = np.concatenate([r_est, t_est[:, :, None]], 2)
    gt = np.concatenate([r_gt, t_gt[:, :, None]], 2)
    r_err, t_err = ev._rot_trans_errors(est, gt)
    k64 = K.astype(np.float64)
    host = {"add": ev._add_errors(est, gt, pts), "adi": ev._adi_errors(est, gt, pts),
            "arp_2d": ev._arp2d_errors(est, gt, pts, k64), "re": r_err, "te": t_err}
    for name, ref in host.items():
        args = _metric_args(name, r_est, t_est, r_gt, t_gt, pts)
        args = [torch.tensor(k64 if a is K else a, dtype=dtype) for a in args]
        got = getattr(tpm, name)(*args).numpy()
        np.testing.assert_allclose(got, ref, rtol=rtol, atol=0, err_msg=name)
