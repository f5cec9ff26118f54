"""Open3D-style point-to-plane ICP baseline "O3D" (counterpart of
``dcreg_tpu/models/o3d_style.py``).

Open3D's algorithm as the reference runs it: target normals estimated
once (k = 30, so K2 keeps 60 candidates per point), 1-NN
correspondences within the search radius, an unweighted point-to-plane
Gauss-Newton step per iteration on the left-perturbation tangent, and
convergence when fitness and rmse change by less than 1e-6.  Each
iteration's log row is packed inline (``logpack``).
"""
from __future__ import annotations

import torch

from ..ops import linalg, se3
from ..ops.knn import nn1
from ..ops.normals import estimate_normals
from ..utils import check_precise, resolve_device
from . import logpack
from .icp import ICPParams, ICPResult, log_from_buffer


def nearest(source_w, target_xyz, target_valid, chunk, grid):
    """((N,) squared distance, (N,) index) of each point's nearest target:
    the grid's 27-cell walk, or ``nn1`` (K2 with kk 8)."""
    if grid is not None:
        from ..ops.voxel_grid import grid_knn
        sq_d, idx = grid_knn(grid, source_w, k=1)
        return sq_d[:, 0], idx[:, 0]
    return nn1(source_w, target_xyz, target_valid, chunk=chunk)


def o3d_icp(source_xyz, target_xyz, R0, t0, params: ICPParams = ICPParams(),
            T_gt=None, target_valid=None, source_valid=None,
            num_source: int | None = None, normal_k: int = 30, grid=None,
            device=None) -> ICPResult:
    """Open3D-equivalent point-to-plane ICP of one frame pair.  ``grid``:
    an optional GridIndex over the target (voxel >= search radius,
    validity baked in) in place of the brute 1-NN scan.  Runs on
    ``device`` (cuda unless told otherwise)."""
    if grid is not None and target_valid is not None:
        raise ValueError("bake target_valid into the GridIndex instead")
    check_precise()
    dev = resolve_device(device)
    source_xyz = torch.as_tensor(source_xyz, device=dev)
    dtype = source_xyz.dtype
    as_dev = lambda x: torch.as_tensor(x, dtype=dtype, device=dev)
    target_xyz = as_dev(target_xyz)
    R, t = as_dev(R0), as_dev(t0)
    T_gt = torch.eye(4, dtype=dtype, device=dev) if T_gt is None \
        else as_dev(T_gt)
    I = params.max_iterations
    denom = float(num_source if num_source is not None
                  else source_xyz.shape[0])
    eye6 = torch.eye(6, dtype=dtype, device=dev)
    normals = estimate_normals(target_xyz, k=normal_k, valid=target_valid,
                               chunk=params.chunk)

    buf = logpack.empty_buffer(I, dtype, dev)
    prev_fit = torch.zeros((), dtype=dtype, device=dev)
    prev_rmse = torch.tensor(float("inf"), dtype=dtype, device=dev)
    converged = torch.zeros((), dtype=torch.bool, device=dev)
    aborted = torch.zeros((), dtype=torch.bool, device=dev)
    H_last = eye6
    k = 0
    while k < I and not bool(converged | aborted):   # one host sync
        p_w = source_xyz @ R.T + t
        sq_d, idx = nearest(p_w, target_xyz, target_valid, params.chunk,
                            grid)
        mask = sq_d < params.corr.search_radius ** 2
        if source_valid is not None:
            mask = mask & source_valid
        n = normals[idx]
        w = mask.to(dtype)
        r = torch.sum((p_w - target_xyz[idx]) * n, dim=-1)
        J = torch.cat([torch.linalg.cross(p_w, n, dim=-1), n],
                      dim=-1) * w[:, None]
        H = J.T @ J
        g = -(J.T @ (w * r))
        dx = linalg.solve_qr_6x6(H + 1e-12 * eye6, g)

        n_valid = torch.sum(mask)
        # masked, not weighted: a point with no neighbour in the grid's
        # reach carries an infinite distance (XLA folds the JAX module's
        # w * sq_d into the same select)
        rmse = torch.sqrt(torch.sum(torch.where(mask, sq_d, 0.0))
                          / torch.clamp(n_valid, min=1).to(dtype))
        fitness = n_valid.to(dtype) / denom
        too_few = n_valid < params.min_effective_points
        abort_now = too_few | ~torch.all(torch.isfinite(dx))
        dx = torch.where(abort_now, 0.0, dx)
        R_new, t_new = se3.boxplus_left(R, t, dx)
        R = torch.where(abort_now, R, R_new)
        t = torch.where(abort_now, t, t_new)
        T_new = se3.se3_matrix(R, t)
        te, re = se3.pose_error(T_gt, T_new)
        buf[k] = logpack.pack_row(
            dtype, dev, executed=~too_few, effective_points=n_valid,
            corr_num=n_valid, rmse=rmse, fitness=fitness, dx=dx,
            transform=T_new, trans_error=te, rot_error_deg=re, H=H)
        converged = (torch.abs(fitness - prev_fit) < 1e-6) & \
            (torch.abs(rmse - prev_rmse) < 1e-6) & ~abort_now
        aborted = abort_now
        H_last = torch.where(abort_now, H_last, H)
        prev_fit, prev_rmse = fitness, rmse
        k += 1

    w_h, V_h = linalg.symmetric_eigh(H_last)
    inv = 1.0 / torch.clamp(torch.abs(w_h), min=1e-12)
    cov = (V_h * inv[None, :]) @ V_h.T
    return ICPResult(R=R, t=t, converged=converged, aborted=aborted,
                     iterations=torch.tensor(k, dtype=torch.int32,
                                             device=dev),
                     covariance=cov, log=log_from_buffer(buf))
