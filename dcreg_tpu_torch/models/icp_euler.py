"""Euler-parameterised (LOAM) point-to-plane ICP (counterpart of
``dcreg_tpu/models/icp_euler.py``): the engine of the method matrix when
``use_so3_parameterization`` is false.

As the reference's: LOAM's coordinate swap (x <- y, y <- z, z <- x) of
points and weighted normals before the trig Jacobian, Jacobian columns
[arz, arx, ary, n_z', n_x', n_y'], an additive update of the pose
[roll, pitch, yaw, x, y, z], convergence on |delta rmse| and
|delta fitness| < 1e-4, and the covariance mapped from Euler rates to
the Lie tangent.  The correspondence, analysis and solve stack is the
SO(3) engine's, and so is the two-pass design: the loop records H, g and
the scalar stats, and the telemetry is rebuilt from them afterwards in
one batched pass over the iterations.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops import linalg, se3
from ..ops.correspondence import find_correspondences
from ..ops.degeneracy import DetectionMethod, HandlingMethod, analyze
from ..ops.solvers import solve
from ..utils import check_precise, resolve_device
from .icp import ICPParams, ICPResult, _empty_log, log_rows


class EulerHist(NamedTuple):
    """Per-iteration state recorded by the loop; dims (I, ...)."""
    pose: torch.Tensor       # (I, 6) pose BEFORE iteration k
    H: torch.Tensor          # (I, 6, 6)
    g: torch.Tensor          # (I, 6)
    num_valid: torch.Tensor  # (I,) int32
    rmse: torch.Tensor
    fitness: torch.Tensor
    objective: torch.Tensor


def _euler_jacobian_rows(points, weighted_normals, pose,
                         faithful: bool = False):
    """LOAM trig Jacobian rows (N, 6), ordered [d/droll, d/dpitch, d/dyaw,
    dx, dy, dz] after the axis swap.  points (N, 3) body frame;
    weighted_normals (N, 3) = s n; pose (6,) [roll, pitch, yaw, x, y, z].

    ``faithful=False`` (default) is the exact derivative of
    n . (R(pose) p + t) under the engine's ZYX composition;
    ``faithful=True`` multiplies the angle-derivative groups by the
    unswapped normal, as the reference's formula does (a cyclic
    mis-permutation of the rotation block that shares GN's fixed point)."""
    srx, crx = torch.sin(pose[1]), torch.cos(pose[1])   # pitch
    sry, cry = torch.sin(pose[2]), torch.cos(pose[2])   # yaw
    srz, crz = torch.sin(pose[0]), torch.cos(pose[0])   # roll

    # LOAM axis swap for both point and normal
    px, py, pz = points[:, 1], points[:, 2], points[:, 0]
    cx, cy, cz = (weighted_normals[:, 1], weighted_normals[:, 2],
                  weighted_normals[:, 0])
    if faithful:
        m1, m2, m3 = cz, cx, cy
    else:
        m1, m2, m3 = cx, cy, cz

    crx_sry = crx * sry
    crz_sry = crz * sry
    srx_sry = srx * sry
    srx_srz = srx * srz
    arx = ((crx_sry * srz * px + crx * crz_sry * py - srx_sry * pz) * m1
           + (-srx_srz * px - crz * srx * py - crx * pz) * m2
           + (crx * cry * srz * px + crx * cry * crz * py
              - cry * srx * pz) * m3)
    ary = (((cry * srx_srz - crz_sry) * px
            + (sry * srz + cry * crz * srx) * py + crx * cry * pz) * m1
           + ((-cry * crz - srx_sry * srz) * px
              + (cry * srz - crz * srx_sry) * py - crx_sry * pz) * m3)
    arz = (((crz * srx_sry - cry * srz) * px
            + (-cry * crz - srx_sry * srz) * py) * m1
           + (crx * crz * px - crx * srz * py) * m2
           + ((sry * srz + cry * crz * srx) * px
              + (crz_sry - cry * srx_srz) * py) * m3)
    return torch.stack([arz, arx, ary, cz, cx, cy], dim=-1)


def icp_point_to_plane_euler(source_xyz, target_xyz, R0, t0,
                             detection: DetectionMethod,
                             handling: HandlingMethod,
                             params: ICPParams = ICPParams(),
                             T_gt=None, target_valid=None, source_valid=None,
                             num_source: int | None = None, grid=None,
                             device=None) -> ICPResult:
    """The Euler/LOAM engine; same interface as
    ``icp_point_to_plane_so3``.  (R0, t0) becomes an Euler pose
    (MatrixToPose6D) that each iteration updates additively.  Runs on
    ``device`` (cuda unless told otherwise)."""
    check_precise()
    dev = resolve_device(device)
    source_xyz = torch.as_tensor(source_xyz, device=dev)
    dtype = source_xyz.dtype
    as_dev = lambda x: torch.as_tensor(x, dtype=dtype, device=dev)
    target_xyz = as_dev(target_xyz)
    T_gt = torch.eye(4, dtype=dtype, device=dev) if T_gt is None \
        else as_dev(T_gt)
    I = params.max_iterations
    pose = se3.matrix_to_pose6d(se3.se3_matrix(as_dev(R0), as_dev(t0)))
    denom = float(num_source if num_source is not None
                  else source_xyz.shape[0])

    z = lambda *s: torch.zeros((I,) + s, dtype=dtype, device=dev)
    nan = lambda: torch.full((I,), float("nan"), dtype=dtype, device=dev)
    hist = EulerHist(pose=z(6), H=z(6, 6), g=z(6),
                     num_valid=torch.zeros(I, dtype=torch.int32, device=dev),
                     rmse=nan(), fitness=nan(), objective=nan())
    prev_rmse = torch.tensor(torch.finfo(dtype).max, dtype=dtype, device=dev)
    prev_fitness = torch.zeros((), dtype=dtype, device=dev)
    converged = torch.zeros((), dtype=torch.bool, device=dev)
    aborted = torch.zeros((), dtype=torch.bool, device=dev)
    k = 0
    while k < I and not bool(converged | aborted):   # one host sync
        T = se3.pose6d_to_matrix(pose)
        corr = find_correspondences(source_xyz, T[:3, :3], T[:3, 3],
                                    target_xyz, target_valid=target_valid,
                                    source_valid=source_valid,
                                    params=params.corr, chunk=params.chunk,
                                    grid=grid)
        s = torch.where(corr.valid, corr.weight, 0.0).to(dtype)
        J = _euler_jacobian_rows(source_xyz, corr.normal * s[:, None], pose)
        J = torch.where(corr.valid[:, None], J, 0.0)
        b = -(s * corr.residual)
        H = J.T @ J
        g = J.T @ b
        n_valid = torch.sum(corr.valid)
        raw_sq = torch.where(corr.valid, corr.residual ** 2, 0.0)
        rmse = torch.sqrt(torch.sum(raw_sq)
                          / torch.clamp(n_valid, min=1).to(dtype))
        fitness = torch.sum(corr.in_radius.to(dtype)) / denom
        analysis = analyze(H, detection, params.thresholds)
        dx, _ = solve(H, g, handling, analysis, params.thresholds,
                      telemetry=False)
        too_few = n_valid < params.min_effective_points
        abort_now = too_few | ~torch.all(torch.isfinite(dx))
        dx = torch.where(abort_now, 0.0, dx)
        hist.pose[k], hist.H[k], hist.g[k] = pose, H, g
        hist.num_valid[k] = n_valid.to(torch.int32)
        hist.rmse[k], hist.fitness[k] = rmse, fitness
        hist.objective[k] = 0.5 * torch.sum(b * b)
        pose = torch.where(abort_now, pose, pose + dx)
        converged = (torch.abs(rmse - prev_rmse) < 1e-4) & \
            (torch.abs(fitness - prev_fitness) < 1e-4) & ~abort_now
        aborted = abort_now
        prev_rmse, prev_fitness = rmse, fitness
        k += 1
    H_last = hist.H[max(k - 1, 0)]

    if params.full_telemetry:
        # the telemetry solve is the generic one, its dx the applied update
        executed = torch.arange(I, device=dev) < k
        ana = analyze(hist.H, detection, params.thresholds)
        dx, sinfo = solve(hist.H, hist.g, handling, ana, params.thresholds,
                          telemetry=True)
        too_few = hist.num_valid < params.min_effective_points
        abort = too_few | ~torch.all(torch.isfinite(dx), dim=-1)
        dx = torch.where(abort[:, None], 0.0, dx)
        T_new = se3.pose6d_to_matrix(hist.pose + dx)
        log = log_rows(hist, executed, too_few, dx, T_new, T_gt, ana, sinfo)
    else:
        log = _empty_log(I, dtype, device=dev)

    # Euler covariance mapped to the Lie tangent
    w_h, V_h = linalg.symmetric_eigh(H_last)
    invertible = torch.amin(torch.abs(w_h)) > 1e-12
    w_inv = 1.0 / torch.where(torch.abs(w_h) > 1e-12, w_h,
                              torch.ones_like(w_h))
    cov_euler = (V_h * w_inv[None, :]) @ V_h.T
    w_c, V_c = linalg.symmetric_eigh(cov_euler)
    cov_euler = (V_c * torch.clamp(w_c, min=1e-9)[None, :]) @ V_c.T
    J_cov = torch.eye(6, dtype=dtype, device=dev)
    J_cov[:3, :3] = se3.euler_to_lie_jacobian(pose[0], pose[1], pose[2])
    cov = J_cov @ cov_euler @ J_cov.T
    w_f, V_f = linalg.symmetric_eigh(cov)
    cov = (V_f * torch.clamp(w_f, min=1e-9)[None, :]) @ V_f.T
    cov = torch.where(converged & invertible, cov,
                      1e6 * torch.eye(6, dtype=dtype, device=dev))

    T_final = se3.pose6d_to_matrix(pose)
    return ICPResult(R=T_final[:3, :3], t=T_final[:3, 3],
                     converged=converged, aborted=aborted,
                     iterations=torch.tensor(k, dtype=torch.int32,
                                             device=dev),
                     covariance=cov, log=log)
