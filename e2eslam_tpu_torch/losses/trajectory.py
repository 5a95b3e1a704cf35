"""Trajectory evaluation: ATE and RPE.

The system is judged on abs-rel depth AND trajectory accuracy (BASELINE.md);
the reference never computes ATE in-tree (it eyeballs plotly trajectories).
Standard definitions:

  * ATE (absolute trajectory error): RMSE of translation differences after
    a closed-form SE(3) (or Sim(3)-less, scale-free rigid) alignment of the
    estimated camera centers to ground truth (Horn/Umeyama).
  * RPE (relative pose error): RMSE of the translation of
    ``inv(rel_gt) @ rel_est`` over a fixed frame delta.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def _centers(poses: np.ndarray) -> np.ndarray:
    """Camera centers of cam-to-world poses [N, 4, 4] -> [N, 3]."""
    return poses[:, :3, 3]


def align_rigid(src: np.ndarray, dst: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Least-squares rigid alignment (R, t) with R @ src + t ~= dst (Horn)."""
    mu_s = src.mean(0)
    mu_d = dst.mean(0)
    H = (src - mu_s).T @ (dst - mu_d)
    U, _, Vt = np.linalg.svd(H)
    S = np.eye(3)
    if np.linalg.det(Vt.T @ U.T) < 0:
        S[2, 2] = -1
    R = Vt.T @ S @ U.T
    t = mu_d - R @ mu_s
    return R, t


def absolute_trajectory_error(gt_poses: np.ndarray, est_poses: np.ndarray) -> float:
    """ATE RMSE (meters) after rigid alignment of camera centers."""
    gt = _centers(np.asarray(gt_poses, np.float64))
    est = _centers(np.asarray(est_poses, np.float64))
    R, t = align_rigid(est, gt)
    aligned = est @ R.T + t
    return float(np.sqrt(np.mean(np.sum((aligned - gt) ** 2, axis=1))))


def relative_pose_error(
    gt_poses: np.ndarray, est_poses: np.ndarray, delta: int = 1
) -> float:
    """RPE translation RMSE over frame pairs ``delta`` apart."""
    gt = np.asarray(gt_poses, np.float64)
    est = np.asarray(est_poses, np.float64)
    errs = []
    for i in range(len(gt) - delta):
        rel_gt = np.linalg.inv(gt[i]) @ gt[i + delta]
        rel_est = np.linalg.inv(est[i]) @ est[i + delta]
        err = np.linalg.inv(rel_gt) @ rel_est
        errs.append(np.sum(err[:3, 3] ** 2))
    return float(np.sqrt(np.mean(errs))) if errs else 0.0
