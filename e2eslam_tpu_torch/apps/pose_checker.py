"""Pose and relative-transform check of a dataset window.

    python -m e2eslam_tpu_torch.apps.pose_checker --config_path CONFIG

The port of ``e2eslam_tpu/apps/pose_checker.py`` (the reference's
``pose_checker.py:57-82``): load a 2-frame window, print its poses and
transforms, and check the identity ``T_12 = [R1^T R2 | R1^T (t2 - t1)]``
against the dataset's transform and the port's ``poses_to_transforms``, in
float64 on the host. Prints PASS when the largest error is under 1e-4.
"""

from __future__ import annotations

import numpy as np
import torch

from e2eslam_tpu_torch.config import load_config
from e2eslam_tpu_torch.core.se3 import poses_to_transforms
from e2eslam_tpu_torch.data.pipeline import load_batch, make_dataset


def check(config, *, verbose: bool = True) -> float:
    """The largest absolute error of the two transforms against the
    identity."""
    dataset = make_dataset(config, sequence_length=2)
    _, _, _, poses, transforms = load_batch(dataset, [0])
    poses, transforms = poses[0].astype(np.float64), transforms[0].astype(np.float64)
    P1, P2 = poses[0], poses[1]
    R1, t1 = P1[:3, :3], P1[:3, 3]
    R2, t2 = P2[:3, :3], P2[:3, 3]
    manual = np.eye(4, dtype=np.float64)
    manual[:3, :3] = R1.T @ R2
    manual[:3, 3] = R1.T @ (t2 - t1)
    computed = poses_to_transforms(torch.from_numpy(poses)).numpy()[1]
    err_dataset = float(np.abs(transforms[1] - manual).max())
    err_computed = float(np.abs(computed - manual).max())
    if verbose:
        print("pose 1:\n", P1)
        print("pose 2:\n", P2)
        print("dataset transform 1->2:\n", transforms[1])
        print("manual [R1^T R2 | R1^T (t2-t1)]:\n", manual)
        print(f"max |dataset - manual|  = {err_dataset:.2e}")
        print(f"max |computed - manual| = {err_computed:.2e}")
    return max(err_dataset, err_computed)


def main(argv=None):
    config = load_config(argv)
    err = check(config)
    print("PASS" if err < 1e-4 else "FAIL", f"(max err {err:.2e})")
    return err


if __name__ == "__main__":
    main()
