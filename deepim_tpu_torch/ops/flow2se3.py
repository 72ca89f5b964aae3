"""Flow -> SE(3) by PnP-RANSAC, in numpy on the host (counterpart of
deepim_tpu/ops/flow2se3.py, which calls cv2.solvePnPRansac and
cv2.Rodrigues; the reference's lib/pair_matching/flow2se3.py).  A
diagnostic and alternative pose recovery: the production pose path is the
network's SE(3) head.

The solver keeps cv2.solvePnPRansac's defaults: at most 100 iterations, an
inlier within 8 px of its reprojection, the iteration count cut as the best
inlier ratio makes a 0.99-confident all-inlier draw likely (cv2's
RANSACUpdateNumIters), zero distortion.  Each iteration draws 6 points from
a seeded generator and scores two closed-form hypotheses on every point: a
normalised DLT of the 3x4 projection (general position) and a
plane-induced homography on the sample's principal plane (planar and
shallow objects, where the DLT is ill-conditioned).  The best hypothesis's
inliers are refined by Levenberg-Marquardt on the reprojection error in
pixels, over an axis-angle update of the pose.  RANSAC's draws are not
cv2's, so the inlier set can differ where errors sit at the threshold; on
consistent correspondences both reach the least-squares pose.
"""
from __future__ import annotations

import numpy as np
import torch

from deepim_tpu_torch.geometry.rotations import mat2quat

SAMPLE = 6             # points a hypothesis is drawn from (the DLT's minimum)
ITERATIONS = 100       # cv2.solvePnPRansac's iterationsCount
REPROJ_ERROR = 8.0     # its reprojectionError, pixels
CONFIDENCE = 0.99      # its confidence
REFINE_ITERATIONS = 100


def flow_correspondences(depth_object: np.ndarray, flow: np.ndarray, mask_image: np.ndarray, k: np.ndarray):
    """The 3D-2D matches flow2se3 solves: pixels where depth and mask are
    both nonzero, backprojected through K^-1 (object points (N, 3)), and
    the same pixels plus the flow (image points (N, 2)), float64."""
    h, w = depth_object.shape
    valid_obj = (depth_object != 0).flatten()
    k_inv = np.linalg.inv(k)
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float64)
    pix = np.stack([xs.ravel(), ys.ravel(), np.ones(h * w)])
    pts3 = (k_inv @ pix) * depth_object.reshape(1, -1)
    tgt_x = (xs + flow[:, :, 0]).flatten()
    tgt_y = (ys + flow[:, :, 1]).flatten()
    valid = np.where(valid_obj & (mask_image != 0).flatten())[0]
    object_points = pts3[:, valid].T.astype(np.float64)
    image_points = np.stack([tgt_x[valid], tgt_y[valid]], axis=1).astype(np.float64)
    return object_points, image_points


def flow2se3(depth_object: np.ndarray, flow: np.ndarray, mask_image: np.ndarray, k: np.ndarray, rng=0):
    """depth_object: (H, W) rendered depth; flow: (H, W, 2) in (dw, dh);
    mask_image: (H, W) observed-object mask; k: (3, 3); rng: a seed or a
    np.random.Generator for RANSAC's draws.  Solves the pose that carries
    flow_correspondences' object points onto their image points.  Returns
    (converged, se3_q (7,): quaternion wxyz with w >= 0, then
    translation); (False, identity) with fewer than 6 matches or when no
    hypothesis has 6 inliers."""
    object_points, image_points = flow_correspondences(depth_object, flow, mask_image, k)
    se3_q = np.zeros(7)
    se3_q[0] = 1.0
    if len(object_points) < SAMPLE:
        return False, se3_q
    found = pnp_ransac(object_points, image_points, np.asarray(k, np.float64), rng)
    if found is None:
        return False, se3_q
    r, t, _ = found
    se3_q[:4] = mat2quat(torch.from_numpy(r)).numpy()
    se3_q[4:] = t
    return True, se3_q


def pnp_ransac(object_points: np.ndarray, image_points: np.ndarray, k: np.ndarray, rng=0):
    """object_points (N, 3), image_points (N, 2) pixels, k (3, 3), all
    float64 -> (R (3, 3), t (3,), inlier mask (N,)) or None when no
    hypothesis reaches SAMPLE inliers or the refinement is not finite."""
    rng = np.random.default_rng(rng)
    n = len(object_points)
    k_inv = np.linalg.inv(k)
    normalized = image_points @ k_inv[:2, :2].T + k_inv[:2, 2]
    thresh2 = REPROJ_ERROR ** 2
    best_count, best = SAMPLE - 1, None
    niters = 1 if n == SAMPLE else ITERATIONS
    it = 0
    with np.errstate(invalid="ignore", divide="ignore", over="ignore"):
        while it < niters:
            sample = rng.choice(n, SAMPLE, replace=False)
            obj, img = object_points[sample], normalized[sample]
            for r, t in (_dlt_pose(obj, img), _planar_pose(obj, img)):
                inliers = _inliers(object_points, image_points, k, r, t, thresh2)
                count = int(inliers.sum())
                if count > best_count:
                    best_count, best = count, (r, t, inliers)
                    niters = _update_iterations(CONFIDENCE, (n - count) / n, SAMPLE, niters)
            it += 1
        if best is None:
            return None
        r, t, inliers = best
        r, t = refine_pose(object_points[inliers], image_points[inliers], k, r, t)
    if not (np.isfinite(r).all() and np.isfinite(t).all()):
        return None
    return r, t, inliers


def _update_iterations(p: float, ep: float, model_points: int, max_iters: int) -> int:
    """cv2's RANSACUpdateNumIters: iterations for confidence p at outlier
    ratio ep, never more than max_iters."""
    num = np.log(max(1.0 - p, np.finfo(np.float64).tiny))
    denom = 1.0 - (1.0 - ep) ** model_points
    if denom < np.finfo(np.float64).tiny:
        return 0
    denom = np.log(denom)
    return max_iters if denom >= 0 or -num >= max_iters * -denom else int(np.floor(num / denom + 0.5))


def _similarity(pts: np.ndarray):
    """Hartley normalisation: (centroid, scale) taking pts to mean distance
    sqrt(dim) from the origin."""
    c = pts.mean(axis=0)
    d = np.linalg.norm(pts - c, axis=1).mean()
    return c, np.sqrt(pts.shape[1]) / max(d, 1e-300)


def _null_vector(a: np.ndarray) -> np.ndarray:
    return np.linalg.svd(a)[2][-1]


def _dlt_rows(src_h: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """Rows of the homogeneous DLT system P src ~ (u, v, 1)."""
    zero = np.zeros_like(src_h)
    return np.concatenate([
        np.concatenate([src_h, zero, -dst[:, :1] * src_h], axis=1),
        np.concatenate([zero, src_h, -dst[:, 1:] * src_h], axis=1),
    ])


def _dlt_pose(obj: np.ndarray, img: np.ndarray):
    """(R, t) of the normalised DLT of one sample: obj (m, 3) points, img
    (m, 2) normalised image coordinates."""
    c3, s3 = _similarity(obj)
    c2, s2 = _similarity(img)
    src = np.concatenate([(obj - c3) * s3, np.ones((len(obj), 1))], axis=1)
    p = _null_vector(_dlt_rows(src, (img - c2) * s2)).reshape(3, 4)
    t3 = np.eye(4)
    t3[:3, :3] *= s3
    t3[:3, 3] = -s3 * c3
    t2_inv = np.array([[1.0 / s2, 0.0, c2[0]], [0.0, 1.0 / s2, c2[1]], [0.0, 0.0, 1.0]])
    p = t2_inv @ p @ t3
    if np.linalg.det(p[:, :3]) < 0:
        p = -p
    u, sv, vt = np.linalg.svd(p[:, :3])
    return u @ vt, p[:, 3] / sv.mean()


def _planar_pose(obj: np.ndarray, img: np.ndarray):
    """(R, t) from the homography of the sample's principal plane to img."""
    c = obj.mean(axis=0)
    q = np.linalg.svd(obj - c)[2].T  # columns: principal directions, the normal last
    if np.linalg.det(q) < 0:
        q[:, 2] = -q[:, 2]
    plane = ((obj - c) @ q)[:, :2]
    cp, sp = _similarity(plane)
    c2, s2 = _similarity(img)
    src = np.concatenate([(plane - cp) * sp, np.ones((len(obj), 1))], axis=1)
    hom = _null_vector(_dlt_rows(src, (img - c2) * s2)).reshape(3, 3)
    tp = np.array([[sp, 0.0, -sp * cp[0]], [0.0, sp, -sp * cp[1]], [0.0, 0.0, 1.0]])
    t2_inv = np.array([[1.0 / s2, 0.0, c2[0]], [0.0, 1.0 / s2, c2[1]], [0.0, 0.0, 1.0]])
    hom = t2_inv @ hom @ tp
    lam = 0.5 * (np.linalg.norm(hom[:, 0]) + np.linalg.norm(hom[:, 1]))
    if hom[2, 2] < 0:  # the plane's origin lies in front of the camera
        lam = -lam
    r1, r2, t_plane = hom[:, 0] / lam, hom[:, 1] / lam, hom[:, 2] / lam
    u, _, vt = np.linalg.svd(np.stack([r1, r2, np.cross(r1, r2)], axis=1))
    r_plane = u @ np.diag([1.0, 1.0, np.linalg.det(u @ vt)]) @ vt
    r = r_plane @ q.T
    return r, t_plane - r @ c


def _inliers(obj, img, k, r, t, thresh2) -> np.ndarray:
    """Points in front of the camera whose squared reprojection error is at
    most thresh2."""
    proj = obj @ (k @ r).T + k @ t
    z = proj[:, 2]
    err2 = (proj[:, 0] / z - img[:, 0]) ** 2 + (proj[:, 1] / z - img[:, 1]) ** 2
    return (z > 0) & (err2 <= thresh2)


def _residual(obj, img, k, r, t):
    cam = obj @ r.T + t
    proj = cam @ k.T
    res = proj[:, :2] / proj[:, 2:3] - img
    return res.ravel(), cam


def _rodrigues(w: np.ndarray) -> np.ndarray:
    theta = np.linalg.norm(w)
    s = np.array([[0.0, -w[2], w[1]], [w[2], 0.0, -w[0]], [-w[1], w[0], 0.0]])
    if theta < 1e-12:
        return np.eye(3) + s
    s = s / theta
    return np.eye(3) + np.sin(theta) * s + (1.0 - np.cos(theta)) * (s @ s)


def refine_pose(obj, img, k, r, t):
    """Levenberg-Marquardt on the summed squared pixel reprojection error
    of obj (N, 3) against img (N, 2), from (r, t).  The update moves each
    camera-frame point X to exp([w]x) X + dt (6 parameters)."""
    res, cam = _residual(obj, img, k, r, t)
    cost = res @ res
    lam = 1e-3
    k2 = k[:2, :2]
    for _ in range(REFINE_ITERATIONS):
        x, y, z = cam[:, 0], cam[:, 1], cam[:, 2]
        zero = np.zeros_like(z)
        inv_z = 1.0 / z
        jn = np.stack([np.stack([inv_z, zero, -x * inv_z ** 2], -1),
                       np.stack([zero, inv_z, -y * inv_z ** 2], -1)], 1)  # d(x/z, y/z)/dX, (N, 2, 3)
        jp = np.einsum("ab,nbc->nac", k2, jn)
        neg_skew = np.stack([np.stack([zero, z, -y], -1), np.stack([-z, zero, x], -1),
                             np.stack([y, -x, zero], -1)], 1)  # dX/dw = -[X]x
        jac = np.concatenate([np.einsum("nab,nbc->nac", jp, neg_skew), jp], axis=2).reshape(-1, 6)
        jtj = jac.T @ jac
        grad = jac.T @ res
        while True:
            step = np.linalg.solve(jtj + lam * np.diag(np.diag(jtj)), -grad)
            rot = _rodrigues(step[:3])
            r_new, t_new = rot @ r, rot @ t + step[3:]
            res_new, cam_new = _residual(obj, img, k, r_new, t_new)
            cost_new = res_new @ res_new
            if cost_new <= cost or lam > 1e12:
                break
            lam *= 10.0
        if not cost_new <= cost:
            break
        done = cost - cost_new <= 1e-15 * cost or np.abs(step).max() < 1e-15
        r, t, res, cam, cost = r_new, t_new, res_new, cam_new, cost_new
        lam = max(lam / 10.0, 1e-12)
        if done:
            break
    return r, t
