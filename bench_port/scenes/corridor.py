"""The degenerate corridor: floor, ceiling, two smooth walls along x and a
thin door frame every ``door_spacing_m``, shifted away from the origin;
a jerky walk along it and body-frame scans around a sensor above each
pose.

A torch copy, on the device and from the seed, of the port's corridor
experiment (``scripts/run_corridor_experiment.corridor_world``,
``gt_trajectory`` and ``make_frames``).  The walk is the experiment's own
(its fixed ``trajectory_seed``), so every run registers the same motion;
the map and the scans come from the run's seed.
"""
from __future__ import annotations

import numpy as np
import torch

from kdorder import kd_leaf_order
from seeds import generator


def world(cfg, seed: int, device) -> torch.Tensor:
    """(M, 3) float32 corridor points on ``device``."""
    g = generator(seed, "world", device)
    u = lambda n: torch.rand(n, generator=g, device=device)
    nrm = lambda n: torch.randn(n, generator=g, device=device)
    L, W, Hh, rho = (cfg["length_m"], cfg["half_width_m"], cfg["height_m"],
                     cfg["density_per_m2"])
    noise = cfg["surface_noise_m"]
    n_floor = int(L * 2 * W * rho)
    parts = []
    for z0 in (0.0, Hh):                        # floor, ceiling
        parts.append(torch.stack([L * u(n_floor), (2 * u(n_floor) - 1) * W,
                                  z0 + noise * nrm(n_floor)], 1))
    n_wall = int(L * Hh * rho)
    for side in (-W, W):
        parts.append(torch.stack([L * u(n_wall), side + noise * nrm(n_wall),
                                  Hh * u(n_wall)], 1))
    fw = cfg["door_frame_width_m"]
    for x0 in np.arange(cfg["door_first_m"], L, cfg["door_spacing_m"]):
        n_f = int(cfg["door_frame_depth_m"] * Hh * rho)
        h = n_f // 2
        gy = torch.cat([-W + fw * u(h), W - fw + fw * u(n_f - h)])
        parts.append(torch.stack([float(x0) + noise * nrm(n_f), gy,
                                  Hh * u(n_f)], 1))
    off = torch.as_tensor(cfg["world_offset_m"], dtype=torch.float32,
                          device=device)
    return torch.cat(parts) + off


def trajectory(cfg):
    """(T_pre2, T_pre1, gt (F, 4, 4)), float64: the two poses before the
    walk and its F poses (sinusoidal acceleration, per-frame velocity and
    yaw noise from ``trajectory_seed``)."""
    rng = np.random.default_rng(cfg["trajectory_seed"])
    step, off = cfg["step_m"], np.asarray(cfg["world_offset_m"])
    x, y = cfg["start_x_m"] - 2 * step, 0.0
    poses = []
    for i in range(-2, cfg["frames"]):
        yaw = np.float32(0.002 * np.sin(0.3 * i) + rng.normal(0, 0.004))
        c, s = np.cos(yaw), np.sin(yaw)
        T = np.eye(4)
        T[:3, :3] = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)
        T[:3, 3] = off + [x, y, 0.0]
        poses.append(T)
        x += step + 0.18 * np.sin(0.12 * i) + rng.normal(0, 0.06)
        y = 0.15 * np.sin(0.2 * i) + rng.normal(0, 0.03)
    return poses[0], poses[1], np.asarray(poses[2:])


def scans(cfg, pts: torch.Tensor, gt: np.ndarray, seed: int) -> torch.Tensor:
    """(F, N, 3) float32 body-frame scans of N points within
    ``scan_range_m`` of a sensor ``sensor_height_m`` above each pose."""
    dev = pts.device
    g = generator(seed, "scans", dev)
    n, r2 = cfg["scan_points"], cfg["scan_range_m"] ** 2
    out = []
    for T in gt:
        Tt = torch.as_tensor(T, dtype=torch.float32, device=dev)
        c, R = Tt[:3, 3], Tt[:3, :3]
        sensor = c + torch.tensor([0.0, 0.0, cfg["sensor_height_m"]],
                                  device=dev)
        near = pts[((pts - sensor) ** 2).sum(1) < r2]
        pick = torch.randperm(near.shape[0], generator=g, device=dev)[:n]
        body = (near[pick] - c) @ R
        out.append(body + cfg["sensor_noise_m"]
                   * torch.randn(body.shape, generator=g, device=dev))
    return torch.stack(out)


def make(cfg, seed: int, device) -> dict:
    pts = world(cfg, seed, device)
    pts = pts[kd_leaf_order(pts, cfg["tb"])]
    T_pre2, T_pre1, gt = trajectory(cfg)
    frames = scans(cfg, pts, gt, seed)
    frames = torch.stack([f[kd_leaf_order(f, 128)] for f in frames])
    return {"world": pts, "frames": frames, "gt": gt, "T_pre1": T_pre1,
            "T_pre2": T_pre2}
