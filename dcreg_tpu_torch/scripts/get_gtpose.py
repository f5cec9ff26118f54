"""Nearest-timestamp ground-truth pose lookup from TUM trajectories
(counterpart of ``scripts/get_gtpose.py``): the GT pose nearest in time
to a query timestamp, or the SE(3) alignment of an estimated trajectory
onto the GT (the evo ``-a`` step).

Usage:
  python -m dcreg_tpu_torch.scripts.get_gtpose GT_TUM TIMESTAMP
  python -m dcreg_tpu_torch.scripts.get_gtpose GT_TUM --align EST_TUM
"""
from __future__ import annotations

import sys

import numpy as np

from ..io.tum import _umeyama_se3, load_tum


def nearest_pose(gt_ts, gt_poses, t, max_dt=0.5):
    i = int(np.argmin(np.abs(gt_ts - t)))
    dt = abs(gt_ts[i] - t)
    if dt > max_dt:
        raise ValueError(f"nearest GT is {dt:.3f}s away (> {max_dt}s)")
    return gt_poses[i], gt_ts[i]


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    gt_ts, gt_poses = load_tum(argv[0])
    if len(argv) >= 2 and argv[1] == "--align":
        est_ts, est_poses = load_tum(argv[2])
        pairs = []
        for t, T in zip(est_ts, est_poses):
            try:
                G, _ = nearest_pose(gt_ts, gt_poses, t)
            except ValueError:
                continue
            pairs.append((T[:3, 3], G[:3, 3]))
        est_t = np.array([p[0] for p in pairs])
        gt_t = np.array([p[1] for p in pairs])
        R, t = _umeyama_se3(est_t, gt_t)
        T = np.eye(4)
        T[:3, :3] = R
        T[:3, 3] = t
        print("alignment T (gt_T_est):")
        print(np.array2string(T, precision=9, suppress_small=False))
    else:
        t = float(argv[1])
        T, ts = nearest_pose(gt_ts, gt_poses, t)
        print(f"nearest GT at t={ts}:")
        print(np.array2string(T, precision=9))


if __name__ == "__main__":
    main()
