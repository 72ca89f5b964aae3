"""LINEMOD pose-evaluation protocols (copy of deepim_tpu/eval/evaluator.py:
numpy and scipy on the host, batched over samples):

* evaluate_pose      — rot/trans/space accuracy over 1..10 deg x 1..10 cm
  threshold grids, with the eggbox 180-deg-z symmetry retry
  (lib/dataset/LM6D_REFINE.py:278-370)
* evaluate_pose_add  — ADD (ADI for eggbox/glue/bowl/cup) at
  0.02/0.05/0.10 x diameter + accuracy-vs-threshold AUC over [0, 0.1d] by
  Simpson integration (LM6D_REFINE.py:372-512)
* evaluate_pose_arp_2d — mean 2D reprojection error at 2/5/10/20 px + AUC
  over [0, 50] px (LM6D_REFINE.py:514-669)

Inputs follow the reference's accumulator layout (tester.py:241-283):
all_poses_est[cls_idx][iter_idx] and all_poses_gt[cls_idx][0] are lists of
3x4 arrays.  Returns nested result dicts (and logs human-readable tables).
"""
from __future__ import annotations

import numpy as np
from scipy.integrate import simpson
from scipy.spatial import cKDTree

from deepim_tpu_torch.data.pairdb import SYMMETRIC_CLASSES
from deepim_tpu_torch.utils.logger import logger

RT_Z_FLIP = np.array([[-1, 0, 0, 0], [0, -1, 0, 0], [0, 0, 1, 0]], np.float64)


def _rot_trans_errors(poses_est: np.ndarray, poses_gt: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Batched geodesic rotation (deg) and translation (m) errors
    (calc_rt_dist_m, RT_transform.py:162-173, via the arccos-trace form)."""
    r_est, r_gt = poses_est[:, :, :3], poses_gt[:, :, :3]
    rel = np.einsum("bji,bjk->bik", r_est, r_gt)
    tr = np.clip((np.trace(rel, axis1=1, axis2=2) - 1.0) / 2.0, -1.0, 1.0)
    r_err = np.degrees(np.arccos(tr))
    t_err = np.linalg.norm(poses_est[:, :, 3] - poses_gt[:, :, 3], axis=1)
    return r_err, t_err


def _apply_eggbox_symmetry(poses_est: np.ndarray, poses_gt: np.ndarray) -> np.ndarray:
    """Retry with a 180-deg rotation about z when the rotation error exceeds
    90 deg (LM6D_REFINE.py:304-307)."""
    r_err, _ = _rot_trans_errors(poses_est, poses_gt)
    flipped = np.einsum("bij,jk->bik", poses_est[:, :, :3], RT_Z_FLIP[:, :3])
    poses_sym = poses_est.copy()
    poses_sym[:, :, :3] = flipped
    # translation: est @ RT_z keeps t (RT_z has zero translation).
    return np.where((r_err > 90)[:, None, None], poses_sym, poses_est)


def _transform(poses, pts) -> np.ndarray:
    """(B, 3, 4) poses applied to (N, 3) points -> (B, N, 3).  A batched
    matmul: np.einsum's unoptimised loop took about a second for 64 poses
    of a 10,242-point model."""
    return np.matmul(pts, poses[:, :, :3].transpose(0, 2, 1)) + poses[:, None, :, 3]


def _add_errors(poses_est, poses_gt, pts) -> np.ndarray:
    return np.linalg.norm(_transform(poses_est, pts) - _transform(poses_gt, pts), axis=2).mean(axis=1)


def _adi_errors(poses_est, poses_gt, pts) -> np.ndarray:
    out = np.zeros(len(poses_est))
    for i in range(len(poses_est)):
        pe = pts @ poses_est[i, :, :3].T + poses_est[i, :, 3]
        pg = pts @ poses_gt[i, :, :3].T + poses_gt[i, :, 3]
        nn = cKDTree(pe)
        d, _ = nn.query(pg, k=1)
        out[i] = d.mean()
    return out


def _arp2d_errors(poses_est, poses_gt, pts, k) -> np.ndarray:
    def proj(poses):
        uv = np.matmul(_transform(poses, pts), k.T)
        return uv[..., :2] / uv[..., 2:3]

    return np.linalg.norm(proj(poses_est) - proj(poses_gt), axis=2).mean(axis=1)


class PoseEvaluator:
    def __init__(self, classes, points: dict, diameters: dict, k: np.ndarray, num_iters: int):
        self.classes = list(classes)
        self.points = points
        self.diameters = diameters
        self.k = np.asarray(k, np.float64)
        self.num_iters = num_iters

    def _iterate(self, all_poses_est, all_poses_gt):
        for cls_idx, cls_name in enumerate(self.classes):
            if not (len(all_poses_est[cls_idx][0]) and len(all_poses_gt[cls_idx][0])):
                continue
            gt = np.asarray(all_poses_gt[cls_idx][0], np.float64)
            for it in range(self.num_iters):
                est = np.asarray(all_poses_est[cls_idx][it], np.float64)
                yield cls_idx, cls_name, it, est, gt

    # -- 5cm 5deg style grids ----------------------------------------------
    def evaluate_pose(self, all_poses_est, all_poses_gt) -> dict:
        rot_thr = np.arange(1, 11, 1.0)
        trans_thr = np.arange(0.01, 0.11, 0.01)
        res: dict = {}
        for cls_idx, cls_name, it, est, gt in self._iterate(all_poses_est, all_poses_gt):
            if cls_name == "eggbox":
                est = _apply_eggbox_symmetry(est, gt)
            r_err, t_err = _rot_trans_errors(est, gt)
            rot_acc = (r_err[:, None] < rot_thr).mean(axis=0)
            trans_acc = (t_err[:, None] < trans_thr).mean(axis=0)
            space_acc = ((r_err[:, None] < rot_thr) & (t_err[:, None] < trans_thr)).mean(axis=0)
            res.setdefault(cls_name, {})[it] = {
                "rot_acc": rot_acc, "trans_acc": trans_acc, "space_acc": space_acc,
                # the 5deg/5cm cell (show_list index 4, LM6D_REFINE.py:320)
                "acc_5cm_5deg": float(space_acc[4]) * 100,
            }
            logger.info(
                "%s iter %d: 5cm5deg %.2f  (rot<5deg %.2f, trans<5cm %.2f)",
                cls_name, it + 1, space_acc[4] * 100, rot_acc[4] * 100, trans_acc[4] * 100,
            )
        return res

    # -- ADD(-S) ------------------------------------------------------------
    def evaluate_pose_add(self, all_poses_est, all_poses_gt) -> dict:
        dx = 0.0001
        grid = np.arange(0, 0.1, dx)
        res: dict = {}
        for cls_idx, cls_name, it, est, gt in self._iterate(all_poses_est, all_poses_gt):
            pts = np.asarray(self.points[cls_name], np.float64)
            diameter = self.diameters[cls_name]
            if cls_name in SYMMETRIC_CLASSES:
                err = _adi_errors(est, gt, pts)
            else:
                err = _add_errors(est, gt, pts)
            acc = {
                "0.02": float((err < 0.02 * diameter).mean()) * 100,
                "0.05": float((err < 0.05 * diameter).mean()) * 100,
                "0.10": float((err < 0.10 * diameter).mean()) * 100,
            }
            curve = (err[:, None] < grid[None, :] * diameter).mean(axis=0)
            acc["auc"] = float(simpson(curve, dx=dx) / 0.1) * 100
            acc["errors"] = err
            res.setdefault(cls_name, {})[it] = acc
            logger.info(
                "%s iter %d: ADD(-S) 0.10d %.2f, 0.05d %.2f, 0.02d %.2f, AUC %.2f",
                cls_name, it + 1, acc["0.10"], acc["0.05"], acc["0.02"], acc["auc"],
            )
        self._log_means(res, ("0.02", "0.05", "0.10", "auc"), "ADD(-S)")
        return res

    # -- reprojection 2D -----------------------------------------------------
    def evaluate_pose_arp_2d(self, all_poses_est, all_poses_gt) -> dict:
        dx = 0.1
        grid = np.arange(0, 50, dx)
        res: dict = {}
        for cls_idx, cls_name, it, est, gt in self._iterate(all_poses_est, all_poses_gt):
            pts = np.asarray(self.points[cls_name], np.float64)
            if cls_name == "eggbox":
                est = _apply_eggbox_symmetry(est, gt)
            err = _arp2d_errors(est, gt, pts, self.k)
            acc = {str(t): float((err < t).mean()) * 100 for t in (2, 5, 10, 20)}
            curve = (err[:, None] < grid[None, :]).mean(axis=0)
            acc["auc"] = float(simpson(curve, dx=dx) / 50.0) * 100
            acc["errors"] = err
            # Per-class accuracy-vs-pixel-threshold curve — the Occlusion
            # LINEMOD reporting artifact (README.md:43-49,
            # assets/LM6d_Occ_results.png).
            acc["curve_thresholds"] = grid
            acc["curve"] = curve * 100.0
            res.setdefault(cls_name, {})[it] = acc
            logger.info(
                "%s iter %d: Proj2D @2px %.2f, @5px %.2f, @10px %.2f, @20px %.2f, AUC %.2f",
                cls_name, it + 1, acc["2"], acc["5"], acc["10"], acc["20"], acc["auc"],
            )
        self._log_means(res, ("2", "5", "10", "20", "auc"), "Proj2D")
        return res

    def _log_means(self, res: dict, keys, label: str) -> None:
        for it in range(self.num_iters):
            vals = {
                k: np.mean([res[c][it][k] for c in res if it in res[c]])
                for k in keys
                if any(it in res[c] for c in res)
            }
            if vals:
                logger.info(
                    "%s mean over %d classes, iter %d: %s",
                    label, len(res), it + 1,
                    ", ".join(f"{k}={v:.2f}" for k, v in vals.items()),
                )
