"""TUM trajectory IO and trajectory metrics (ATE / RPE / registration
recall / map accuracy); counterpart of ``dcreg_tpu/io/tum.py``.

The reference's evaluation runs `evo_ape tum gt est -va` on TUM-format
trajectories and reports ATE / RRE / RTE / RR (recall iff RRE < 5 deg and
RTE < 0.2 m); this module scores the odometry's output the same way
without external tools.  Host tooling in numpy (scipy for the map
accuracy); tensors are accepted and copied to the host.
"""
from __future__ import annotations

import numpy as np
import torch


def _np(x):
    """A numpy array of ``x``; a tensor is copied to the host first."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _rot_to_quat_np(R):
    """(3, 3) rotation -> (w, x, y, z) quaternion in numpy (Shepperd's
    method, as ops/se3.rot_to_quat)."""
    R = np.asarray(R, np.float64)
    tr = R[0, 0] + R[1, 1] + R[2, 2]
    if tr > 0:
        s = np.sqrt(tr + 1.0) * 2.0
        q = np.array([0.25 * s, (R[2, 1] - R[1, 2]) / s,
                      (R[0, 2] - R[2, 0]) / s, (R[1, 0] - R[0, 1]) / s])
    elif R[0, 0] >= R[1, 1] and R[0, 0] >= R[2, 2]:
        s = np.sqrt(1.0 + R[0, 0] - R[1, 1] - R[2, 2]) * 2.0
        q = np.array([(R[2, 1] - R[1, 2]) / s, 0.25 * s,
                      (R[0, 1] + R[1, 0]) / s, (R[0, 2] + R[2, 0]) / s])
    elif R[1, 1] >= R[2, 2]:
        s = np.sqrt(1.0 - R[0, 0] + R[1, 1] - R[2, 2]) * 2.0
        q = np.array([(R[0, 2] - R[2, 0]) / s, (R[0, 1] + R[1, 0]) / s,
                      0.25 * s, (R[1, 2] + R[2, 1]) / s])
    else:
        s = np.sqrt(1.0 - R[0, 0] - R[1, 1] + R[2, 2]) * 2.0
        q = np.array([(R[1, 0] - R[0, 1]) / s, (R[0, 2] + R[2, 0]) / s,
                      (R[1, 2] + R[2, 1]) / s, 0.25 * s])
    return q / np.linalg.norm(q)


def _quat_to_rot_np(q):
    """(w, x, y, z) quaternion -> (3, 3) rotation in numpy."""
    w, x, y, z = np.asarray(q, np.float64) / np.linalg.norm(q)
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def save_tum(path, timestamps, poses):
    """Write TUM format: `t x y z qx qy qz qw` per line.

    poses: (F, 4, 4) arrays or tensors."""
    poses = _np(poses)
    timestamps = _np(timestamps).astype(np.float64)
    with open(path, "w") as f:
        for ts, T in zip(timestamps, poses):
            q = _rot_to_quat_np(T[:3, :3])
            # (w, x, y, z) internally; TUM wants qx qy qz qw
            t = T[:3, 3]
            f.write(f"{ts:.9f} {t[0]:.9f} {t[1]:.9f} {t[2]:.9f} "
                    f"{q[1]:.9f} {q[2]:.9f} {q[3]:.9f} {q[0]:.9f}\n")


def load_tum(path):
    """Read TUM format -> (timestamps (F,), poses (F, 4, 4))."""
    ts, poses = [], []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            vals = [float(v) for v in line.split()]
            t, x, y, z, qx, qy, qz, qw = vals[:8]
            T = np.eye(4)
            T[:3, :3] = _quat_to_rot_np([qw, qx, qy, qz])
            T[:3, 3] = [x, y, z]
            ts.append(t)
            poses.append(T)
    return np.asarray(ts), np.asarray(poses)


def _umeyama_se3(est_t, gt_t):
    """Best-fit SE(3) alignment (rotation+translation, no scale) of
    estimated positions onto ground truth -- evo's `-a` alignment."""
    mu_e = est_t.mean(0)
    mu_g = gt_t.mean(0)
    cov = (gt_t - mu_g).T @ (est_t - mu_e) / est_t.shape[0]
    U, _, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U @ Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    t = mu_g - R @ mu_e
    return R, t


def ate(est_poses, gt_poses, align: bool = True):
    """Absolute trajectory error of positions (RMSE, mean, median, max) in
    meters, optionally after SE(3) alignment (evo_ape ... -a)."""
    est_t = _np(est_poses)[:, :3, 3]
    gt_t = _np(gt_poses)[:, :3, 3]
    if align and est_t.shape[0] >= 3:
        R, t = _umeyama_se3(est_t, gt_t)
        est_t = est_t @ R.T + t
    err = np.linalg.norm(est_t - gt_t, axis=1)
    return dict(rmse=float(np.sqrt((err ** 2).mean())),
                mean=float(err.mean()), median=float(np.median(err)),
                max=float(err.max()), errors=err)


def rpe(est_poses, gt_poses, delta: int = 1):
    """Relative pose error over frame pairs (i, i+delta): per-pair
    rotation error (deg) and translation error (m)."""
    est = _np(est_poses)
    gt = _np(gt_poses)
    F = est.shape[0]
    rot_err, trans_err = [], []
    for i in range(F - delta):
        dE = np.linalg.inv(est[i]) @ est[i + delta]
        dG = np.linalg.inv(gt[i]) @ gt[i + delta]
        dd = np.linalg.inv(dG) @ dE
        trans_err.append(np.linalg.norm(dd[:3, 3]))
        c = np.clip((np.trace(dd[:3, :3]) - 1) / 2, -1, 1)
        rot_err.append(np.degrees(np.arccos(c)))
    return np.asarray(rot_err), np.asarray(trans_err)


def map_accuracy(scans, est_poses, map_xyz, max_dist: float = 1.0,
                 sample: int = 200_000, seed: int = 0):
    """MapEval-style "AC" map accuracy: aggregate every scan transformed
    by its ESTIMATED pose, and measure the mean/RMSE nearest-neighbor
    distance to the reference map (the reference's external MapEval
    step, the "AC" column of the reference's ablation table).

    scans: (F, N, 3) body-frame frames (or list of (Ni, 3)); est_poses:
    (F, 4, 4); map_xyz: (M, 3).  Distances above ``max_dist`` are
    clamped (MapEval's inlier convention); ``sample`` bounds the
    aggregated cloud for tractable host-side evaluation."""
    from scipy.spatial import cKDTree

    est_poses = _np(est_poses)
    pts = []
    for scan, T in zip(scans, est_poses):
        scan = _np(scan)
        pts.append(scan @ T[:3, :3].T + T[:3, 3])
    agg = np.concatenate(pts, axis=0)
    if agg.shape[0] > sample:
        rng = np.random.default_rng(seed)
        agg = agg[rng.choice(agg.shape[0], sample, replace=False)]
    tree = cKDTree(_np(map_xyz))
    d, _ = tree.query(agg, k=1)
    d = np.minimum(d, max_dist)
    return dict(ac_mean=float(d.mean()),
                ac_rmse=float(np.sqrt((d ** 2).mean())),
                ac_median=float(np.median(d)),
                inlier_frac=float((d < max_dist).mean()),
                points=int(agg.shape[0]))


def registration_recall(est_poses, gt_poses, rre_thresh_deg: float = 5.0,
                        rte_thresh_m: float = 0.2):
    """Per-frame recall against GT (RRE < 5 deg and RTE < 0.2 m),
    evaluated on absolute per-frame pose error."""
    est = _np(est_poses)
    gt = _np(gt_poses)
    ok = []
    for Te, Tg in zip(est, gt):
        d = np.linalg.inv(Tg) @ Te
        te = np.linalg.norm(d[:3, 3])
        c = np.clip((np.trace(d[:3, :3]) - 1) / 2, -1, 1)
        re = np.degrees(np.arccos(c))
        ok.append(re < rre_thresh_deg and te < rte_thresh_m)
    ok = np.asarray(ok)
    return float(ok.mean()), ok
