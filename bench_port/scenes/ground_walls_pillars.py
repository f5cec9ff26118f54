"""The map-scale localization scene: undulating ground, wall strips and
pillars over a square of side 2 x extent, a 2-frame-primed S-curve between
the wall lines, and body-frame scans drawn around each pose.

A torch copy, on the device and from the seed, of the port's smoke
scene (``chip_smoke.synthetic_map``, ``trajectory`` and ``scans``).  The
trajectory depends on no seed; the map and the scans do.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from kdorder import kd_leaf_order
from seeds import generator


def extent(cfg) -> float:
    return max(cfg["min_extent_m"],
               (cfg["map_points"] / cfg["points_per_m2"]) ** 0.5)


def world(cfg, seed: int, device) -> torch.Tensor:
    """(M, 3) float32 map points on ``device``."""
    n, E = cfg["map_points"], extent(cfg)
    g = generator(seed, "world", device)
    u = lambda *shape: torch.rand(shape, generator=g, device=device)
    nrm = lambda *shape: torch.randn(shape, generator=g, device=device)
    ng = int(n * cfg["ground_share"])
    xy = (2 * u(ng, 2) - 1) * E
    z = 0.5 * torch.sin(0.12 * xy[:, 0]) * torch.cos(0.1 * xy[:, 1]) \
        + 0.01 * nrm(ng)
    ground = torch.cat([xy, z[:, None]], 1)
    del xy, z
    nw = int(n * cfg["wall_share"])
    wall = torch.stack([
        (2 * u(nw) - 1) * E,
        torch.round(6 * u(nw) - 3) * (E / 3.0) + 0.02 * nrm(nw),
        5 * u(nw)], 1)
    npl = n - ng - nw
    n_pil = max(8, int((2 * E) ** 2 / 60.0))
    centers = (2 * u(n_pil, 2) - 1) * E
    which = torch.randint(0, n_pil, (npl,), generator=g, device=device)
    ang = 2 * math.pi * u(npl)
    pil = torch.stack([centers[which, 0] + 0.4 * torch.cos(ang),
                       centers[which, 1] + 0.4 * torch.sin(ang),
                       6 * u(npl)], 1)
    out = torch.cat([ground, wall, pil])
    out[:, 2] += cfg["map_lift_m"]
    return out


def trajectory(cfg):
    """(T_pre2, T_pre1, gt (F, 4, 4)): an integrated S-curve between the
    wall lines, float64."""
    E = extent(cfg)
    lift = cfg["map_lift_m"]
    pos = np.array([9.0, -0.45 * (E / 3.0), lift + 0.8])
    poses = []
    for i in range(-2, cfg["frames"]):
        yaw = 0.3 + 0.35 * np.sin(0.05 * i) + 0.01 * np.sin(0.25 * i)
        c, s = np.cos(yaw), np.sin(yaw)
        T = np.eye(4)
        T[:3, :3] = [[c, -s, 0], [s, c, 0], [0, 0, 1.0]]
        T[:3, 3] = pos
        poses.append(T)
        step = 0.22 + 0.06 * np.sin(0.2 * i)
        pos = pos + [step * c, step * s, 0.0]
    return poses[0], poses[1], np.asarray(poses[2:])


def scans(cfg, pts: torch.Tensor, gt: np.ndarray, seed: int) -> torch.Tensor:
    """(F, N, 3) float32 body-frame scans: N points drawn without
    replacement from the map within ``scan_range_m`` of each pose, plus
    Gaussian sensor noise."""
    dev = pts.device
    g = generator(seed, "scans", dev)
    lo = torch.as_tensor(gt[:, :3, 3].min(0) - cfg["tube_margin_m"],
                         dtype=torch.float32, device=dev)
    hi = torch.as_tensor(gt[:, :3, 3].max(0) + cfg["tube_margin_m"],
                         dtype=torch.float32, device=dev)
    tube = pts[((pts >= lo) & (pts <= hi)).all(1)]
    n, r2 = cfg["scan_points"], cfg["scan_range_m"] ** 2
    out = []
    for T in gt:
        Tt = torch.as_tensor(T, dtype=torch.float32, device=dev)
        c, R = Tt[:3, 3], Tt[:3, :3]
        near = tube[((tube - c) ** 2).sum(1) < r2]
        pick = torch.randperm(near.shape[0], generator=g, device=dev)[:n]
        body = (near[pick] - c) @ R
        out.append(body + cfg["sensor_noise_m"]
                   * torch.randn(body.shape, generator=g, device=dev))
    return torch.stack(out)


def make(cfg, seed: int, device) -> dict:
    """The scene's inputs: the map in kd-leaf order, the kd-sorted scans,
    the ground truth and the two poses before frame 0."""
    pts = world(cfg, seed, device)
    pts = pts[kd_leaf_order(pts, cfg["tb"])]
    T_pre2, T_pre1, gt = trajectory(cfg)
    frames = scans(cfg, pts, gt, seed)
    frames = torch.stack([f[kd_leaf_order(f, 128)] for f in frames])
    return {"world": pts, "frames": frames, "gt": gt, "T_pre1": T_pre1,
            "T_pre2": T_pre2}
