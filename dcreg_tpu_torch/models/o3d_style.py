"""Open3D-style point-to-plane ICP baseline "O3D" (counterpart of
``dcreg_tpu/models/o3d_style.py``).

Open3D's algorithm as the reference runs it: target normals estimated
once (k = 30, so K2 keeps 60 candidates per point), 1-NN
correspondences within the search radius, an unweighted point-to-plane
Gauss-Newton step per iteration on the left-perturbation tangent, and
convergence when fitness and rmse change by less than 1e-6.  Each
iteration's log row is packed inline (``logpack``) at a device-side
counter; the loop is a prologue, a step and an epilogue (``O3DLoop``),
replayed as CUDA graphs on the card (``graphs``).
"""
from __future__ import annotations

import torch

from .. import graphs
from ..ops import linalg, se3
from ..ops.knn import nn1
from ..ops.normals import estimate_normals
from . import logpack
from .icp import (ICPParams, ICPResult, IterationLog, PairInputs,
                  log_from_buffer, run_pair_loop)


def nearest(source_w, target_xyz, target_valid, chunk, grid):
    """((N,) squared distance, (N,) index) of each point's nearest target:
    the grid's 27-cell walk, or ``nn1`` (K2 with kk 8)."""
    if grid is not None:
        from ..ops.voxel_grid import grid_knn
        sq_d, idx = grid_knn(grid, source_w, k=1)
        return sq_d[:, 0], idx[:, 0]
    return nn1(source_w, target_xyz, target_valid, chunk=chunk)


class O3DLoop(PairInputs):
    """One configuration of ``o3d_icp`` split into the parts of its
    compiled loop over a ``graphs.State`` (as ``icp.PairLoop``): the
    ``prologue`` estimates the target normals (K2 at kk ``2 normal_k`` on
    the brute-force backend) and sets the pose, the flags, ``H_last``,
    ``prev_fit`` / ``prev_rmse``, the empty log buffer and the counter
    ``k``; the ``step`` runs one iteration and writes its packed log row
    at ``k``; the ``epilogue`` the covariance and the structured log."""

    name = "o3d_icp"

    def __init__(self, target_xyz, N: int, params: ICPParams, target_valid,
                 source_valid, num_source, normal_k: int, grid, device,
                 dtype):
        self.target, self.grid = target_xyz, grid
        self.target_valid, self.source_valid = target_valid, source_valid
        self.N, self.normal_k, self.params = N, normal_k, params
        self.denom = float(num_source if num_source is not None else N)
        self.dev, self.dtype = device, dtype

    def key(self) -> tuple:
        return (self.name, self.N, self.denom, self.normal_k, self.params,
                str(self.dtype), str(self.dev), graphs.tensor_key(
                    self.target, self.grid, self.target_valid,
                    self.source_valid))

    def prologue(self, S) -> None:
        dtype, dev = self.dtype, self.dev
        S.put("normals", estimate_normals(self.target, k=self.normal_k,
                                          valid=self.target_valid,
                                          chunk=self.params.chunk))
        false = torch.zeros((), dtype=torch.bool, device=dev)
        S.put("R", S.R0)
        S.put("t", S.t0)
        S.put("prev_fit", torch.zeros((), dtype=dtype, device=dev))
        S.put("prev_rmse", torch.full((), float("inf"), dtype=dtype,
                                      device=dev))
        S.put("conv", false)
        S.put("abt", false)
        S.put("done", false)
        S.put("H_last", torch.eye(6, dtype=dtype, device=dev))
        S.put("buf", logpack.empty_buffer(self.params.max_iterations, dtype,
                                          dev))
        S.put("k", torch.zeros((), dtype=torch.int64, device=dev))

    def step(self, S) -> None:
        params, dtype = self.params, self.dtype
        target = self.target
        R, t = S.R, S.t
        eye6 = torch.eye(6, dtype=dtype, device=self.dev)
        p_w = S.src @ R.T + t
        sq_d, idx = nearest(p_w, target, self.target_valid, params.chunk,
                            self.grid)
        mask = sq_d < params.corr.search_radius ** 2
        if self.source_valid is not None:
            mask = mask & self.source_valid
        n = S.normals[idx]
        w = mask.to(dtype)
        r = torch.sum((p_w - target[idx]) * n, dim=-1)
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
        fitness = n_valid.to(dtype) / self.denom
        too_few = n_valid < params.min_effective_points
        abort_now = too_few | ~torch.all(torch.isfinite(dx))
        dx = torch.where(abort_now, 0.0, dx)
        R_new, t_new = se3.boxplus_left(R, t, dx)
        R = torch.where(abort_now, R, R_new)
        t = torch.where(abort_now, t, t_new)
        T_new = se3.se3_matrix(R, t)
        te, re = se3.pose_error(S.T_gt, T_new)
        row = logpack.pack_row(
            dtype, self.dev, executed=~too_few, effective_points=n_valid,
            corr_num=n_valid, rmse=rmse, fitness=fitness, dx=dx,
            transform=T_new, trans_error=te, rot_error_deg=re, H=H)
        S.put_row("buf", S.k, row, params.max_iterations)
        conv = (torch.abs(fitness - S.prev_fit) < 1e-6) & \
            (torch.abs(rmse - S.prev_rmse) < 1e-6) & ~abort_now
        S.put("R", R)
        S.put("t", t)
        S.put("H_last", torch.where(abort_now, S.H_last, H))
        S.put("prev_fit", fitness)
        S.put("prev_rmse", rmse)
        S.put("conv", conv)
        S.put("abt", abort_now)
        S.put("k", S.k + 1)
        S.put("done", conv | abort_now)

    def epilogue(self, S) -> None:
        w_h, V_h = linalg.symmetric_eigh(S.H_last)
        inv = 1.0 / torch.clamp(torch.abs(w_h), min=1e-12)
        S.put("cov", (V_h * inv[None, :]) @ V_h.T)
        S.put("iterations", S.k.to(torch.int32))
        S.put_tuple("log", log_from_buffer(S.buf))

    def result(self, S) -> ICPResult:
        return ICPResult(R=S.R, t=S.t, converged=S.conv, aborted=S.abt,
                         iterations=S.iterations, covariance=S.cov,
                         log=S.get_tuple("log", IterationLog))


def o3d_icp(source_xyz, target_xyz, R0, t0, params: ICPParams = ICPParams(),
            T_gt=None, target_valid=None, source_valid=None,
            num_source: int | None = None, normal_k: int = 30, grid=None,
            device=None, graph=None) -> ICPResult:
    """Open3D-equivalent point-to-plane ICP of one frame pair.  ``grid``:
    an optional GridIndex over the target (voxel >= search radius,
    validity baked in) in place of the brute 1-NN scan.  Runs on
    ``device`` (cuda unless told otherwise); on the card the loop's parts
    (``O3DLoop``) replay CUDA graphs, ``graph=False`` runs them eagerly,
    and on the CPU they run eagerly and ``graph=True`` raises."""
    if grid is not None and target_valid is not None:
        raise ValueError("bake target_valid into the GridIndex instead")
    return run_pair_loop(
        lambda target, N, dev, dtype: O3DLoop(
            target, N, params, target_valid, source_valid, num_source,
            normal_k, grid, dev, dtype),
        source_xyz, target_xyz, R0, t0, T_gt, params.max_iterations, device,
        graph)
