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
one batched pass over the iterations.  So is the loop's form: a
prologue, a step and an epilogue over fixed state tensors
(``EulerLoop``), replayed as CUDA graphs on the card.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops import linalg, se3
from ..ops.correspondence import find_correspondences
from ..ops.degeneracy import DetectionMethod, HandlingMethod, analyze
from ..ops.solvers import solve
from .icp import (ICPParams, ICPResult, IterationLog, PairLoop, _empty_log,
                  log_rows, run_pair_loop)


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


def _lie_covariance(H_last, pose, converged):
    """The repaired inverse of the Euler-rate Hessian ``H_last`` mapped
    to the Lie tangent at ``pose``; 1e6 I unless converged and
    invertible."""
    dtype, dev = H_last.dtype, H_last.device
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
    return torch.where(converged & invertible, cov,
                       1e6 * torch.eye(6, dtype=dtype, device=dev))


class EulerLoop(PairLoop):
    """One configuration of ``icp_point_to_plane_euler`` as the parts of
    its compiled loop over a ``graphs.State``, as ``icp.PairLoop`` (the
    same inputs, statics and key): the ``prologue`` makes the Euler pose
    and the loop state (the previous rmse and fitness of the convergence
    test, the history, the device-side iteration counter ``k``); the
    ``step`` is one iteration, the history row ``k`` written through a
    comparison mask, and the ``done`` flag; the ``epilogue`` the
    telemetry pass (or the empty log), the covariance and the final
    pose."""

    name = "icp_point_to_plane_euler"

    def __init__(self, target_xyz, N: int, detection: DetectionMethod,
                 handling: HandlingMethod, params: ICPParams, target_valid,
                 source_valid, num_source, grid, device, dtype):
        super().__init__(target_xyz, N, detection, handling, params,
                         target_valid, source_valid, num_source, grid,
                         device, dtype)
        self.denom = float(num_source if num_source is not None else N)

    def prologue(self, S) -> None:
        I, dtype, dev = self.params.max_iterations, self.dtype, self.dev
        false = torch.zeros((), dtype=torch.bool, device=dev)
        S.put("pose", se3.matrix_to_pose6d(se3.se3_matrix(S.R0, S.t0)))
        S.put("prev_rmse", torch.full((), torch.finfo(dtype).max,
                                      dtype=dtype, device=dev))
        S.put("prev_fitness", torch.zeros((), dtype=dtype, device=dev))
        S.put("conv", false)
        S.put("abt", false)
        S.put("done", false)
        S.put("k", torch.zeros((), dtype=torch.int64, device=dev))
        z = lambda *s: torch.zeros((I,) + s, dtype=dtype, device=dev)
        nan = lambda: torch.full((I,), float("nan"), dtype=dtype, device=dev)
        S.put_tuple("hist", EulerHist(
            pose=z(6), H=z(6, 6), g=z(6),
            num_valid=torch.zeros(I, dtype=torch.int32, device=dev),
            rmse=nan(), fitness=nan(), objective=nan()))

    def step(self, S) -> None:
        params, dtype, pose = self.params, self.dtype, S.pose
        T = se3.pose6d_to_matrix(pose)
        corr = find_correspondences(S.src, T[:3, :3], T[:3, 3], self.target,
                                    target_valid=self.target_valid,
                                    source_valid=self.source_valid,
                                    params=params.corr, chunk=params.chunk,
                                    grid=self.grid)
        s = torch.where(corr.valid, corr.weight, 0.0).to(dtype)
        J = _euler_jacobian_rows(S.src, corr.normal * s[:, None], pose)
        J = torch.where(corr.valid[:, None], J, 0.0)
        b = -(s * corr.residual)
        H = J.T @ J
        g = J.T @ b
        n_valid = torch.sum(corr.valid)
        raw_sq = torch.where(corr.valid, corr.residual ** 2, 0.0)
        rmse = torch.sqrt(torch.sum(raw_sq)
                          / torch.clamp(n_valid, min=1).to(dtype))
        fitness = torch.sum(corr.in_radius.to(dtype)) / self.denom
        analysis = analyze(H, self.detection, params.thresholds)
        dx, _ = solve(H, g, self.handling, analysis, params.thresholds,
                      telemetry=False)
        too_few = n_valid < params.min_effective_points
        abort_now = too_few | ~torch.all(torch.isfinite(dx))
        dx = torch.where(abort_now, 0.0, dx)
        for name, value in (("pose", pose), ("H", H), ("g", g),
                            ("num_valid", n_valid.to(torch.int32)),
                            ("rmse", rmse), ("fitness", fitness),
                            ("objective", 0.5 * torch.sum(b * b))):
            S.put_row(f"hist.{name}", S.k, value, params.max_iterations)
        conv = (torch.abs(rmse - S.prev_rmse) < 1e-4) & \
            (torch.abs(fitness - S.prev_fitness) < 1e-4) & ~abort_now
        S.put("pose", torch.where(abort_now, pose, pose + dx))
        S.put("prev_rmse", rmse)
        S.put("prev_fitness", fitness)
        S.put("conv", conv)
        S.put("abt", abort_now)
        S.put("k", S.k + 1)
        S.put("done", conv | abort_now)

    def epilogue(self, S) -> None:
        params, dtype, dev = self.params, self.dtype, self.dev
        I = params.max_iterations
        hist = S.get_tuple("hist", EulerHist)
        last = torch.clamp(S.k - 1, min=0).reshape(1)
        if params.full_telemetry:
            # the telemetry solve is the generic one, its dx the applied
            # update
            executed = torch.arange(I, device=dev) < S.k
            ana = analyze(hist.H, self.detection, params.thresholds)
            dx, sinfo = solve(hist.H, hist.g, self.handling, ana,
                              params.thresholds, telemetry=True)
            too_few = hist.num_valid < params.min_effective_points
            abort = too_few | ~torch.all(torch.isfinite(dx), dim=-1)
            dx = torch.where(abort[:, None], 0.0, dx)
            T_new = se3.pose6d_to_matrix(hist.pose + dx)
            log = log_rows(hist, executed, too_few, dx, T_new, S.T_gt, ana,
                           sinfo)
        else:
            log = _empty_log(I, dtype, device=dev)
        S.put_tuple("log", log)
        S.put("cov", _lie_covariance(hist.H.index_select(0, last)[0],
                                     S.pose, S.conv))
        S.put("T_final", se3.pose6d_to_matrix(S.pose))
        S.put("iterations", S.k.to(torch.int32))

    def result(self, S) -> ICPResult:
        return ICPResult(R=S.T_final[:3, :3], t=S.T_final[:3, 3],
                         converged=S.conv, aborted=S.abt,
                         iterations=S.iterations, covariance=S.cov,
                         log=S.get_tuple("log", IterationLog))


def icp_point_to_plane_euler(source_xyz, target_xyz, R0, t0,
                             detection: DetectionMethod,
                             handling: HandlingMethod,
                             params: ICPParams = ICPParams(),
                             T_gt=None, target_valid=None, source_valid=None,
                             num_source: int | None = None, grid=None,
                             device=None, graph=None) -> ICPResult:
    """The Euler/LOAM engine; same interface as
    ``icp_point_to_plane_so3``.  (R0, t0) becomes an Euler pose
    (MatrixToPose6D) that each iteration updates additively.  Runs on
    ``device`` (cuda unless told otherwise), as CUDA graph replays of its
    parts (``EulerLoop``) on the card unless ``graph=False``; on the CPU
    eagerly, where ``graph=True`` raises."""
    return run_pair_loop(
        lambda target, N, dev, dtype: EulerLoop(
            target, N, detection, handling, params, target_valid,
            source_valid, num_source, grid, dev, dtype),
        source_xyz, target_xyz, R0, t0, T_gt, params.max_iterations, device,
        graph)
