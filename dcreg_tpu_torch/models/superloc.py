"""SuperLoc baseline (counterpart of ``dcreg_tpu/models/superloc.py``):
robust point-to-plane registration with a feature-observability
analysis.

One outer iteration, as the reference runs it: correspondences by a
first-neighbour gate within the search radius and a 5-NN plane refit
with a viewpoint-oriented normal and a fit-quality weight
``max(0.1, 1 - sqrt(msd / (3 * planeRes)))``; four damped Gauss-Newton
steps with Tukey IRLS weights on the left-perturbation tangent (the
normal equations of the reference's Ceres solve, damping 1e-4 diag);
converged iff rmse < 0.01.  The observability histogram votes each
point's cross product p x n to its best-aligned rotation axis (both
signs, the reference's tie) and its normal to its best-aligned
translation axis; uncertainty = 3 x the histogram fraction, capped at 1;
a direction is degenerate below 0.2 / 0.1 / 0.2.  The covariance is the
tangent (J^T W J)^-1 with cond_* = sqrt(lambda_max / lambda_min).  The
registration is a prologue and an epilogue (``SuperLocLoop``), replayed
as CUDA graphs on the card (``graphs``).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .. import graphs
from ..ops import linalg, se3
from ..ops.correspondence import fit_planes
from ..ops.knn import knn
from .icp import (ICPParams, ICPResult, IterationLog, PairInputs,
                  _empty_log, run_pair_loop)

PLANE_RESOLUTION = 0.1      # the reference's default planeRes


class SuperLocInfo(NamedTuple):
    uncertainties: torch.Tensor    # (6,) [x, y, z, roll, pitch, yaw]
    histogram: torch.Tensor        # (9,) int32
    cond_full: torch.Tensor
    cond_rot: torch.Tensor
    cond_trans: torch.Tensor
    is_degenerate: torch.Tensor
    degeneracy_mask: torch.Tensor  # (6,) [wx wy wz | x y z]


def _correspondences(source_xyz, R, t, target_xyz, target_valid, radius,
                     chunk, grid=None):
    """(valid, normal, d_off, fit_q, p_w): the first-neighbour gate, the
    5-NN plane with its normal turned toward the query point, and the fit
    quality.  With ``grid`` (a GridIndex of voxel >= radius) the 5-NN come
    from the 27-cell neighbourhood, and a set with a missing neighbour is
    invalid."""
    p_w = source_xyz @ R.T + t
    if grid is not None:
        from ..ops.voxel_grid import grid_knn
        sq_d, idx = grid_knn(grid, p_w, k=5)
        idx = torch.clamp(idx, 0, target_xyz.shape[0] - 1)
    else:
        sq_d, idx = knn(p_w, target_xyz, target_valid, k=5, chunk=chunk,
                        refine=10)
    gate = sq_d[:, 0] <= radius * radius
    if grid is not None:
        gate = gate & torch.isfinite(sq_d[:, 4])
    neigh = target_xyz[idx]
    normal, d_off, fit_ok = fit_planes(neigh)
    flip = torch.sum(p_w * normal, dim=-1) < 0.0
    normal = torch.where(flip[:, None], -normal, normal)
    d_off = torch.where(flip, -d_off, d_off)
    dev = torch.einsum('nkj,nj->nk', neigh, normal) + d_off[:, None]
    msd = torch.mean(dev * dev, dim=-1)
    fit_q = torch.clamp(
        1.0 - torch.sqrt(msd / (3.0 * PLANE_RESOLUTION)), min=0.1)
    return gate & fit_ok, normal, d_off, fit_q, p_w


def _observability_histogram(p_w, normal, valid, R):
    """(9,) int32 votes: bins 0..5 the rotation axes (+x, -x, +y, -y, +z,
    -z), each point voting for both signs of the axis its p x n aligns
    with best (|c . a| ties between the signs, and the reference's stable
    sort takes the pair); bins 6..8 the translation axis its normal
    aligns with best.  Axes are R's columns; argmax takes the first of
    equal maxima, as jnp.argmax does."""
    cross = torch.linalg.cross(p_w, normal, dim=-1)
    best_axis = torch.argmax(torch.abs(cross @ R), dim=-1)
    best_trans = torch.argmax(torch.abs(normal @ R), dim=-1)
    rot = torch.stack([torch.sum(valid & (best_axis == a)) for a in range(3)])
    trans = torch.stack([torch.sum(valid & (best_trans == a))
                         for a in range(3)])
    return torch.cat([rot.repeat_interleave(2), trans]).to(torch.int32)


def _tukey_weight(r, a):
    """Ceres TukeyLoss IRLS weight rho'(s), s = r^2."""
    u = 1.0 - (r * r) / (a * a)
    return torch.where(u > 0.0, u * u, 0.0)


class SuperLocLoop(PairInputs):
    """One configuration of ``superloc_register`` as the parts of its
    compiled form over a ``graphs.State``.  Its inner loop has a fixed
    trip count (the JAX ``scan``), so it has no step: the ``prologue``
    finds the correspondences and runs the ``inner_iters`` damped GN
    steps; the ``epilogue`` the metrics at the final pose, the
    observability histogram, the covariance, the log with its row 0
    written through a comparison mask, and the ``SuperLocInfo``.
    ``drive(run, S, 0)`` runs it."""

    name = "superloc_register"

    def __init__(self, target_xyz, N: int, params: ICPParams, target_valid,
                 source_valid, num_source, inner_iters: int, grid, device,
                 dtype):
        self.target, self.grid = target_xyz, grid
        self.target_valid, self.source_valid = target_valid, source_valid
        self.N, self.params, self.inner_iters = N, params, inner_iters
        self.denom = float(num_source if num_source is not None else N)
        self.dev, self.dtype = device, dtype

    def key(self) -> tuple:
        return (self.name, self.N, self.denom, self.inner_iters, self.params,
                str(self.dtype), str(self.dev), graphs.tensor_key(
                    self.target, self.grid, self.target_valid,
                    self.source_valid))

    def prologue(self, S) -> None:
        params, dtype = self.params, self.dtype
        tukey_a = (3.0 * PLANE_RESOLUTION) ** 0.5
        src, R, t = S.src, S.R0, S.t0
        valid, normal, d_off, fit_q, _ = _correspondences(
            src, R, t, self.target, self.target_valid,
            params.corr.search_radius, params.chunk, grid=self.grid)
        if self.source_valid is not None:
            valid = valid & self.source_valid
        # damped GN steps with Tukey IRLS (the reference's inner Ceres
        # solve)
        for _ in range(self.inner_iters):
            p_w = src @ R.T + t
            r = torch.sum(p_w * normal, dim=-1) + d_off
            w = fit_q * _tukey_weight(r, tukey_a) * valid.to(dtype)
            J = torch.cat([torch.linalg.cross(p_w, normal, dim=-1), normal],
                          dim=-1)
            Jw = J * w[:, None]
            H = Jw.T @ J
            g = -(Jw.T @ r)
            dx = linalg.solve_qr_6x6(
                H + 1e-4 * torch.diag(torch.diagonal(H)), g)
            dx = torch.where(torch.all(torch.isfinite(dx)), dx, 0.0)
            R, t = se3.boxplus_left(R, t, dx)
        S.put("valid", valid)
        S.put("normal", normal)
        S.put("d_off", d_off)
        S.put("R", R)
        S.put("t", t)
        S.put("H", H)

    def epilogue(self, S) -> None:
        params, dtype, dev = self.params, self.dtype, self.dev
        I = params.max_iterations
        R, t, valid, H_final = S.R, S.t, S.valid, S.H
        n_valid = torch.sum(valid)
        # metrics at the final pose
        p_w = S.src @ R.T + t
        r = torch.sum(p_w * S.normal, dim=-1) + S.d_off
        r_masked = torch.where(valid, r, 0.0)
        rmse = torch.sqrt(torch.sum(r_masked * r_masked)
                          / torch.clamp(n_valid, min=1).to(dtype))
        inliers = torch.sum(valid & (torch.abs(r) < 0.3))
        fitness = inliers.to(dtype) / self.denom

        # observability histogram and uncertainties
        hist = _observability_histogram(p_w, S.normal, valid, R)
        histf = hist.to(dtype)
        tot_t = torch.clamp(histf[6] + histf[7] + histf[8], min=1e-12)
        unc_xyz = torch.clamp(histf[6:9] / tot_t * 3.0, max=1.0)
        tot_r = torch.clamp(torch.sum(histf[:6]), min=1e-12)
        unc_rpy = torch.clamp(torch.stack([
            (histf[0] + histf[1]) / tot_r * 3.0,
            (histf[2] + histf[3]) / tot_r * 3.0,
            (histf[4] + histf[5]) / tot_r * 3.0]), max=1.0)
        # the per-axis thresholds (0.2, 0.1, 0.2)
        below = lambda u: torch.stack([u[0] < 0.2, u[1] < 0.1, u[2] < 0.2])
        mask6 = torch.cat([below(unc_rpy), below(unc_xyz)])
        is_degen = torch.any(mask6)

        # tangent covariance and its condition numbers
        def cond(w_asc):
            return torch.sqrt(torch.clamp(w_asc[-1], min=1e-10)
                              / torch.clamp(w_asc[0], min=1e-10))

        w_h, V_h = linalg.symmetric_eigh(H_final)
        inv = 1.0 / torch.clamp(w_h, min=1e-10)
        cov = (V_h * inv[None, :]) @ V_h.T
        T_new = se3.se3_matrix(R, t)
        te, re = se3.pose_error(S.T_gt, T_new)

        wf, _ = linalg.symmetric_eigh(H_final)
        row0 = dict(
            executed=torch.ones((), dtype=torch.bool, device=dev),
            effective_points=inliers, rmse=rmse, fitness=fitness,
            objective=0.5 * torch.sum(r_masked ** 2), transform=T_new,
            trans_error=te, rot_error_deg=re, eigenvalues_full=wf,
            singular_values=torch.flip(torch.abs(wf), (0,)),
            cond_full=linalg.condition_number(wf), is_degenerate=is_degen,
            degenerate_mask=mask6, H=H_final)
        first = torch.arange(I, device=dev) == 0
        log = _empty_log(I, dtype, device=dev)._asdict()
        for name, v in row0.items():
            empty = log[name]
            sel = first.reshape((I,) + (1,) * (empty.ndim - 1))
            log[name] = torch.where(sel, v.to(empty.dtype)[None], empty)
        S.put_tuple("log", IterationLog(**log))
        S.put("cov", cov)
        S.put("conv", rmse < 0.01)
        S.put("abt", n_valid < params.min_effective_points)
        S.put("iterations", torch.ones((), dtype=torch.int32, device=dev))
        S.put_tuple("info", SuperLocInfo(
            uncertainties=torch.cat([unc_xyz, unc_rpy]), histogram=hist,
            cond_full=cond(linalg.symmetric_eigh(cov)[0]),
            cond_rot=cond(linalg.symmetric_eigh(cov[:3, :3])[0]),
            cond_trans=cond(linalg.symmetric_eigh(cov[3:, 3:])[0]),
            is_degenerate=is_degen, degeneracy_mask=mask6))

    def result(self, S):
        return (ICPResult(R=S.R, t=S.t, converged=S.conv, aborted=S.abt,
                          iterations=S.iterations, covariance=S.cov,
                          log=S.get_tuple("log", IterationLog)),
                S.get_tuple("info", SuperLocInfo))


def superloc_register(source_xyz, target_xyz, R0, t0,
                      params: ICPParams = ICPParams(), T_gt=None,
                      target_valid=None, source_valid=None,
                      num_source: int | None = None, inner_iters: int = 4,
                      grid=None, device=None, graph=None):
    """SuperLoc registration of one frame pair.  Returns (ICPResult with
    one logged iteration, SuperLocInfo).  ``grid``: an optional GridIndex
    over the target (validity baked in).  Runs on ``device`` (cuda unless
    told otherwise); on the card its parts (``SuperLocLoop``) replay CUDA
    graphs, ``graph=False`` runs them eagerly, and on the CPU they run
    eagerly and ``graph=True`` raises."""
    if grid is not None and target_valid is not None:
        raise ValueError("bake target_valid into the GridIndex instead")
    return run_pair_loop(
        lambda target, N, dev, dtype: SuperLocLoop(
            target, N, params, target_valid, source_valid, num_source,
            inner_iters, grid, dev, dtype),
        source_xyz, target_xyz, R0, t0, T_gt, 0, device, graph)
