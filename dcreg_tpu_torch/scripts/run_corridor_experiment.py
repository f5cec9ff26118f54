"""End-to-end Table-II-style experiment: scan-to-map odometry along a
degenerate corridor, DCReg against the ME-* and FCN baselines
(counterpart of ``scripts/run_corridor_experiment.py``).

The world is a corridor (floor, ceiling, two smooth walls along x) whose
only longitudinal constraint is a thin door frame every 15 m: the
corridor axis is weakly but really constrained on every frame.  The
platform's motion is jerky, so the constant-velocity seed is 5-10 cm off
every frame.  Truncating or biasing handlers (ME-SR, ME-TReg, FCN-SR)
lose the axis and drift by metres; DCReg keeps it at the cm level.

Every method runs through the port's localization loop
``run_odometry_map`` (two-level map index, one B = 1 map-mode
registration per frame with a reused pair list, K1 every ICP iteration)
with the full per-frame 6x6 spectrum as telemetry.  Per method: the TUM
trajectory, its scores (``evaluate_trajectory.evaluate``: ATE, RPE,
registration recall, AC map accuracy) and the per-frame degeneracy
telemetry in the reference's condition_numbers_detailed.csv schema
(Iteration = frame).  ``scripts/plot_degeneracy_timeline.py`` (no JAX)
draws the timeline figure from that CSV where matplotlib exists.

Usage: python -m dcreg_tpu_torch.scripts.run_corridor_experiment
           [OUT_DIR] [--device cpu]
(default OUT_DIR: a fresh directory under the repository's chiprun_out/;
the device is cuda unless --device says otherwise.)
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np
import torch

from ..io.tum import save_tum
from ..models.icp import ICPParams
from ..models.odometry import (estimate_odometry_capacities, prepare_frames,
                               run_odometry_map)
from ..ops import se3
from ..ops.block_sparse import build_map_index, kd_block_order
from ..utils import resolve_device
from .evaluate_trajectory import evaluate

METHODS = [
    ("DCReg", "SCHUR_CONDITION_NUMBER", "PRECONDITIONED_CG"),
    ("ME-SR", "FULL_EVD_MIN_EIGENVALUE", "SOLUTION_REMAPPING"),
    ("ME-TSVD", "FULL_EVD_MIN_EIGENVALUE", "TRUNCATED_SVD"),
    ("ME-TReg", "FULL_EVD_MIN_EIGENVALUE", "STANDARD_REGULARIZATION"),
    ("FCN-SR", "FULL_SVD_CONDITION", "SOLUTION_REMAPPING"),
    ("NONE", "NONE", "NONE"),
]
# ME-TSVD keeps the reference's recorded index-space truncation
# (ops/solvers.solve_truncated_svd drops the STRONGEST direction), which
# is why its translation survives the corridor while ME-SR's does not.

# the corridor sits away from the map-frame origin (see corridor_world)
WORLD_OFFSET = np.array([30.0, 25.0, 6.0])

REF_HEADER = (
    "Method,Iteration,Effective_Points,RMSE,Fitness,Cond_Schur_Rot,"
    "Cond_Schur_Trans,Cond_Diag_Rot,Cond_Diag_Trans,Cond_Full_EVD_Sub_Rot,"
    "Cond_Full_EVD_Sub_Trans,Cond_Full_SVD,"
    + ",".join(f"Lambda_Schur_Rot_{i}" for i in range(3)) + ","
    + ",".join(f"Lambda_Schur_Trans_{i}" for i in range(3)) + ","
    + ",".join(f"Eigenvalues_Full_{i}" for i in range(6)) + ","
    + ",".join(f"Singular_Values_{i}" for i in range(6)) + ","
    "Is_Degenerate,"
    + ",".join(f"Degenerate_Mask_{i}" for i in range(6)))

FRAMES = 45
SCAN_POINTS = 1500          # the reference corridor's 1-2k-point scans
WARM_FRAMES = 2
# cull radius: seed error (~0.1 m) + converged 5th-NN distance (~0.17 m)
# + slack; the reuse margin keeps the whole jerky sequence breach-free
R_CULL0, REUSE_MARGIN = 0.55, 1.2
MAX_ITERATIONS = 8          # a real-time per-frame iteration budget


def corridor_world(length=100.0, half_w=3.0, height=3.0, density=60.0,
                   seed=4):
    """Floor, ceiling, two smooth walls along x and thin door frames every
    15 m, shifted by WORLD_OFFSET: the LOAM-style plane fit n.p = -1 is
    singular for planes through the origin.  Numpy only, from ``seed``;
    bit-equal to the JAX script's world."""
    rng = np.random.default_rng(seed)

    def _slab(n, xs, ys, zs):
        return np.column_stack([xs(n), ys(n), zs(n)])

    n_floor = int(length * 2 * half_w * density)
    floor = _slab(n_floor, lambda n: rng.uniform(0, length, n),
                  lambda n: rng.uniform(-half_w, half_w, n),
                  lambda n: rng.normal(0, 0.002, n))
    ceiling = _slab(n_floor, lambda n: rng.uniform(0, length, n),
                    lambda n: rng.uniform(-half_w, half_w, n),
                    lambda n: height + rng.normal(0, 0.002, n))
    walls = []
    n_wall = int(length * height * density)
    for side in (-half_w, half_w):
        walls.append(_slab(n_wall, lambda n: rng.uniform(0, length, n),
                           lambda n: side + rng.normal(0, 0.002, n),
                           lambda n: rng.uniform(0, height, n)))
    doors = []
    for x0 in np.arange(10.0, length, 15.0):
        # ~54 points per door: lambda_x of ~10-30 in a scan, below the
        # ME-* eigenvalue threshold (120) on every frame
        n_f = int(0.3 * height * density)
        gy = rng.uniform(-half_w, -half_w + 0.8, n_f // 2)
        gy2 = rng.uniform(half_w - 0.8, half_w, n_f - n_f // 2)
        gy = np.concatenate([gy, gy2])
        gz = rng.uniform(0, height, n_f)
        gx = x0 + rng.normal(0, 0.002, n_f)
        doors.append(np.column_stack([gx, gy, gz]))
    return np.vstack([floor, ceiling] + walls + doors) + WORLD_OFFSET


def gt_trajectory(F=FRAMES, step=0.5, x0=5.0):
    """(T_pre2, T_pre1, gt): two pre-start poses (the known initial
    velocity of the motion model) and the F frame poses of a jerky walk
    (sinusoidal acceleration and per-frame velocity noise).

    Each yaw rotation is built in float32 through ``se3.exp_so3``, as
    the JAX script builds it (its JAX runs without x64), so the poses
    carry the same float32 rounding as the recorded trajectory."""
    rng = np.random.default_rng(13)
    poses = []
    x = x0 - 2 * step
    y = 0.0
    for i in range(-2, F):
        yaw = 0.002 * np.sin(0.3 * i) + rng.normal(0, 0.004)
        R = se3.exp_so3(torch.tensor([0.0, 0.0, yaw],
                                     dtype=torch.float32)).numpy()
        T = np.eye(4)
        T[:3, :3] = R
        T[:3, 3] = WORLD_OFFSET + [x, y, 0.0]
        poses.append(T)
        x += step + 0.18 * np.sin(0.12 * i) + rng.normal(0, 0.06)
        y = 0.15 * np.sin(0.2 * i) + rng.normal(0, 0.03)
    return np.asarray(poses[0]), np.asarray(poses[1]), np.asarray(poses[2:])


def make_frames(world, gt, n=2000, fov=10.0, noise=0.012, seed=9):
    """Body-frame scans of ``n`` points within ``fov`` of the sensor
    (0.8 m above each pose), with Gaussian noise; numpy only."""
    rng = np.random.default_rng(seed)
    sensor_h = 0.8
    frames = []
    for T in gt:
        c = T[:3, 3] + [0, 0, sensor_h]
        d2 = np.sum((world - c) ** 2, axis=1)
        near = world[d2 < fov * fov]
        sel = near[rng.choice(near.shape[0], n, replace=False)]
        body = (sel - T[:3, 3]) @ T[:3, :3] + rng.normal(0, noise, (n, 3))
        frames.append(body)
    return np.asarray(frames)


def prepare(device, world=None, frames_n=FRAMES, scan_points=SCAN_POINTS):
    """The experiment's inputs on ``device``: the corridor (or ``world``),
    its trajectory and scans, the sorted map and its index, and the
    loop's capacities and parameters."""
    world = corridor_world() if world is None else world
    T_pre2, T_pre1, gt = gt_trajectory(frames_n)
    frames = make_frames(world, gt, n=scan_points)
    world_s = world[kd_block_order(world, 128)].astype(np.float32)
    mindex = build_map_index(world_s, tb=128, sb=16, device=device)
    frames_s = prepare_frames(frames)
    caps = estimate_odometry_capacities(mindex, frames_s, gt,
                                        R_CULL0 + REUSE_MARGIN)
    return {"world": world, "gt": gt, "T_pre1": T_pre1, "T_pre2": T_pre2,
            "frames": frames, "frames_s": frames_s, "mindex": mindex,
            "world_s": torch.as_tensor(world_s, device=device),
            "caps": caps, "params": ICPParams(max_iterations=MAX_ITERATIONS)}


def run_method(inp, detection, handling, device, n_frames=None):
    """``run_odometry_map`` of one method over the first ``n_frames``
    frames (all by default), seeded one frame before the sequence with
    the known initial velocity, full per-frame telemetry."""
    S, G, P = inp["caps"]
    frames = inp["frames_s"] if n_frames is None \
        else inp["frames_s"][:n_frames]
    return run_odometry_map(
        frames, inp["mindex"], inp["world_s"], T0=inp["T_pre1"],
        T_prev_init=inp["T_pre2"], detection=detection, handling=handling,
        icp_params=inp["params"], num_supers=S, max_per_query=G,
        num_pairs=P, initial_cull_radius=R_CULL0,
        reuse_margin=REUSE_MARGIN, frame_analysis_fast=False,
        device=device)


def csv_rows(name, res):
    """The per-frame telemetry of one method in REF_HEADER's schema."""
    host = lambda x: x.cpu().numpy()
    eff, rmse, fit = (host(res.effective_points), host(res.rmse),
                      host(res.fitness))
    c_rot, c_trans, c_full = (host(res.cond_schur_rot),
                              host(res.cond_schur_trans),
                              host(res.cond_full))
    deg = host(res.is_degenerate).astype(int)
    mask = host(res.degenerate_mask).astype(int)
    rows = []
    for k in range(eff.shape[0]):
        row = [name, str(k), str(int(eff[k])), f"{float(rmse[k]):.8f}",
               f"{float(fit[k]):.8f}", f"{float(c_rot[k]):.6f}",
               f"{float(c_trans[k]):.6f}", "0", "0", "0", "0",
               f"{float(c_full[k]):.6f}"]
        row += ["0"] * 18
        row += [str(int(deg[k]))]
        row += [str(int(mask[k, d])) for d in range(6)]
        rows.append(",".join(row))
    return rows


def envelope_ok(summary):
    """The reference-envelope gate (supp.pdf Table II corridor): DCReg at
    the cm level with high recall, while the truncating and biasing
    handlers fail by an order of magnitude or more."""
    dc = summary["DCReg"]["ate_raw_rmse_m"]
    return (dc < 0.10
            and summary["DCReg"]["registration_recall"] > 0.95
            and summary["ME-SR"]["ate_raw_rmse_m"] > 10 * dc
            and summary["ME-TReg"]["ate_raw_rmse_m"] > 10 * dc
            and summary["FCN-SR"]["ate_raw_rmse_m"] > 10 * dc)


def default_out_dir():
    """A fresh directory under the repository's chiprun_out/."""
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    base = os.path.join(root, "chiprun_out")
    os.makedirs(base, exist_ok=True)
    return tempfile.mkdtemp(prefix="corridor_", dir=base)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(out_dir=None, device=None, inputs=None, after_method=None):
    """Run the six methods over the corridor on ``device`` (cuda unless
    told otherwise), write the artifacts to ``out_dir`` and return 0 when
    the reference envelope holds, else 1.  ``inputs``: ``prepare``'s
    result on that device, built here when not given; ``after_method``:
    called with each method's name once its runs are done."""
    dev = resolve_device(device)
    out_dir = default_out_dir() if out_dir is None else out_dir
    os.makedirs(out_dir, exist_ok=True)
    inp = prepare(dev) if inputs is None else inputs
    F = inp["frames"].shape[0]
    ts = np.arange(F) * 0.1
    scans = inp["frames"].astype(np.float32)
    map_xyz = inp["world"].astype(np.float32)
    np.save(os.path.join(out_dir, "map.npy"), map_xyz)
    np.save(os.path.join(out_dir, "scans.npy"), scans)
    gt_path = os.path.join(out_dir, "gt.tum")
    save_tum(gt_path, ts, inp["gt"])

    rows = [REF_HEADER]
    summary = {}
    for name, det, hand in METHODS:
        run_method(inp, det, hand, dev, n_frames=WARM_FRAMES)   # warm-up
        _sync(dev)
        t0 = time.perf_counter()
        res = run_method(inp, det, hand, dev)
        _sync(dev)
        wall_s = time.perf_counter() - t0
        est_path = os.path.join(out_dir, f"{name}.tum")
        save_tum(est_path, ts, res.poses.double())
        rows += csv_rows(name, res)
        metrics = evaluate(gt_path, est_path, scans=scans, map_xyz=map_xyz)
        metrics["ms_per_frame_wall"] = round(wall_s / F * 1e3, 3)
        metrics["backend"] = dev.type
        metrics["degenerate_frames"] = int(res.is_degenerate.sum())
        metrics["converged_frames"] = int(res.converged.sum())
        metrics["pair_overflow_max"] = int(res.pair_overflow.max())
        summary[name] = metrics
        if after_method is not None:
            after_method(name)
        print(f"{name:8s} ATE {metrics['ate_raw_rmse_m'] * 100:7.2f} cm  "
              f"RR {metrics['registration_recall']:.3f}  "
              f"AC {metrics['map_accuracy']['ac_rmse'] * 100:6.2f} cm  "
              f"deg-frames {metrics['degenerate_frames']}/{F}  "
              f"{metrics['ms_per_frame_wall']:.2f} ms/frame "
              f"[{metrics['backend']}]", flush=True)

    with open(os.path.join(out_dir, "condition_numbers_detailed.csv"),
              "w") as f:
        f.write("\n".join(rows) + "\n")
    with open(os.path.join(out_dir, "corridor_summary.json"), "w") as f:
        json.dump(summary, f, indent=2)
    best = min(summary, key=lambda m: summary[m]["ate_raw_rmse_m"])
    print(f"best ATE: {best}")
    print(f"wrote {out_dir}")
    return 0 if envelope_ok(summary) else 1


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("out_dir", nargs="?", default=None)
    ap.add_argument("--device", default=None,
                    help="cpu runs the plain PyTorch path; default cuda")
    args = ap.parse_args()
    sys.exit(main(args.out_dir, args.device))
