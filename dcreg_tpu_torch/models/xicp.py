"""X-ICP baseline, localizability-aware ICP (counterpart of
``dcreg_tpu/models/xicp.py``).

The engine differs from the DCReg one in three ways: 1-NN
correspondences against target normals estimated once (k = 5, so K2
keeps 10 candidates per point), left-perturbation updates, and a
localizability detection over alignment statistics in place of Hessian
spectra.  Detectors (the reference's dispatch):

* XICP_OPTIMIZED_EQUALITY: per eigenvector of each 3x3 diagonal block,
  the sums of thresholded |alignments|; localizable iff the combined sum
  reaches enough_info or the strong one insufficient_info.
* XICP_EQUALITY / XICP_INEQUALITY: centred cross products, a three-level
  decision and a partial-constraint value solved from the best-aligned
  points (a rank selection by a stable sort, so equal alignments keep
  index order, as ``jnp.argsort`` does).
* XICP_SOLUTION_REMAPPING: the 6x6 spectrum's eigenvalue-threshold
  projection and per-axis masks.

Solvers: XICP_CONSTRAINT, one Ceres-LM step from zero, (H + mu diag(H))
dx = b with mu = 1e-4 and the equality penalties added, and for the
inequality variant Ceres' step acceptance against the true cost (a
rejected step is zero, which the engine reads as convergence);
XICP_PROJECTION, the SVD pseudo-inverse (threshold 1e-6), then the
remapping matrix or the per-direction projections.

The reference's engine never resets its correspondence count and plane
error across iterations, so its logged fitness is cumulative (> 1) and
its rmse a running average; both are reproduced.

The JAX ``jit`` over a ``while_loop`` is a prologue (the target
normals), a step (one iteration and its packed log row at a device-side
counter) and an epilogue (``XICPLoop``), replayed as CUDA graphs on the
card (``graphs``).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from .. import graphs
from ..config import XICPParamsConfig
from ..ops import linalg, se3
from ..ops.degeneracy import DetectionMethod, HandlingMethod
from ..ops.normals import estimate_normals
from . import logpack
from .icp import (ICPParams, ICPResult, IterationLog, PairInputs,
                  log_from_buffer, run_pair_loop)
from .o3d_style import nearest


class XICPDetection(NamedTuple):
    loc_rot: torch.Tensor           # (3,) bool: True = localizable
    loc_trans: torch.Tensor         # (3,) bool
    constraint_rot: torch.Tensor    # (3,) constraint values
    constraint_trans: torch.Tensor  # (3,)
    V_rot: torch.Tensor             # (3, 3) rotation directions (columns)
    V_trans: torch.Tensor           # (3, 3)
    remap_P: torch.Tensor           # (6, 6) solution-remapping projection
    n_high_rot: torch.Tensor        # () int32: the strongly aligned count
    # of the LAST rotation eigenvector scanned, which the reference keeps
    # in one running counter and logs as corr_num


def _eigen_analysis_3x3(H):
    """Direction bases of the diagonal blocks, descending singular values
    (for PSD blocks the SVD U is the EVD basis reversed)."""
    wr, Vr = linalg.symmetric_eigh(H[:3, :3])
    wt, Vt = linalg.symmetric_eigh(H[3:, 3:])
    return (torch.flip(Vr, (-1,)), torch.flip(Vt, (-1,)),
            torch.flip(wr, (-1,)), torch.flip(wt, (-1,)))


def _crosses(points, normals, center=None):
    """Cross-product alignment vectors, normalised only where |c| >= 1."""
    p = points if center is None else points - center[None, :]
    c = torch.linalg.cross(p, normals, dim=-1)
    norm = torch.linalg.norm(c, dim=-1, keepdim=True)
    return torch.where(norm < 1.0, c, c / torch.clamp(norm, min=1e-30))


def _direction_contributions(align_vecs, direction, mask,
                             cfg: XICPParamsConfig):
    """(|alignments|, combined sum, strong sum) of one direction."""
    cos_min = math.cos(math.radians(cfg.minimal_alignment_angle_deg))
    cos_strong = math.cos(math.radians(cfg.strong_alignment_angle_deg))
    a = torch.where(mask, torch.abs(align_vecs @ direction), 0.0)
    combined = torch.sum(torch.where(a >= cos_min, a, 0.0))
    high = torch.sum(torch.where(a >= cos_strong, a, 0.0))
    return a, combined, high


def detect_optimized(src_w, normals, H, mask, cfg: XICPParamsConfig):
    """The optimized-equality detector."""
    V_rot, V_trans, _, _ = _eigen_analysis_3x3(H)
    crosses = _crosses(src_w, normals)

    def localizable(V, vecs):
        out = []
        for i in range(3):
            _, comb, high = _direction_contributions(vecs, V[:, i], mask,
                                                     cfg)
            out.append((comb >= cfg.enough_info_threshold)
                       | (high >= cfg.insufficient_info_threshold))
        return torch.stack(out)

    loc_rot = localizable(V_rot, crosses)
    loc_trans = localizable(V_trans, normals)
    return XICPDetection(
        loc_rot=loc_rot, loc_trans=loc_trans,
        constraint_rot=loc_rot.to(H.dtype),
        constraint_trans=loc_trans.to(H.dtype),
        V_rot=V_rot, V_trans=V_trans,
        remap_P=torch.eye(6, dtype=H.dtype, device=H.device),
        n_high_rot=torch.zeros((), dtype=torch.int32, device=H.device))


def _ternary_one_subspace(align_vecs, direction, deltas, normals, points,
                          mask, is_rot, inequality, cfg: XICPParamsConfig):
    """Ternary localizability of one direction and its partial-constraint
    value.  Returns (localizable, constraint, strongly aligned count)."""
    dtype = direction.dtype
    a, combined, high = _direction_contributions(align_vecs, direction, mask,
                                                 cfg)
    cos_min = math.cos(math.radians(cfg.minimal_alignment_angle_deg))
    cos_strong = math.cos(math.radians(cfg.strong_alignment_angle_deg))
    n_contrib = torch.sum((a >= cos_min) & mask).to(torch.int32)
    n_high = torch.sum((a >= cos_strong) & mask).to(torch.int32)

    fully_loc = (combined >= cfg.high_info_threshold) | \
        (high >= cfg.enough_info_threshold)
    mixed = ~fully_loc & (combined >= cfg.enough_info_threshold)
    high_only = ~fully_loc & ~mixed & \
        (high >= cfg.insufficient_info_threshold)
    insufficient = ~(fully_loc | mixed | high_only)

    # how many of the best-aligned points the partial constraint samples
    zero = torch.zeros((), dtype=torch.int32, device=a.device)
    n_sample = torch.where(mixed, n_contrib,
                           torch.where(high_only, n_high, zero))
    n_total = torch.sum(mask).to(torch.int32)
    n_sample = torch.minimum(
        torch.clamp(n_sample, min=int(cfg.insufficient_info_threshold)),
        n_total)
    n_sample = torch.where(mixed | high_only, n_sample, zero)

    # rank of each point by descending alignment, masked points last; the
    # stable sort keeps equal keys in index order, as jnp.argsort does
    order = torch.argsort(torch.where(mask, -a, float("inf")), stable=True)
    rank = torch.empty_like(order)
    rank[order] = torch.arange(order.shape[0], device=order.device)
    w = ((rank < n_sample) & mask).to(dtype)
    if is_rot:
        center = torch.sum(points * w[:, None], 0) / \
            torch.clamp(torch.sum(w), min=1.0)
        avec = _crosses(points, normals, center)
    else:
        avec = normals
    partial_A = torch.einsum('n,ni,nj->ij', w, avec, avec)
    dot = torch.sum(deltas * normals, dim=-1)
    partial_b = -torch.einsum('n,ni,n->i', w, avec, dot)
    # the SVD-based solve of the reference's stable path
    wA, VA = linalg.symmetric_eigh(partial_A)
    big = torch.abs(wA) > 1e-9
    inv = torch.where(big, 1.0 / torch.where(big, wA, torch.ones_like(wA)),
                      0.0)
    x_partial = (VA * inv[None, :]) @ VA.T @ partial_b
    solved_c = direction @ x_partial

    if inequality:
        c_mixed = torch.clamp(cfg.inequality_bound_multiplier * combined
                              / cfg.high_info_threshold, max=1.0)
        c_sampled = torch.clamp(
            torch.abs(solved_c) * cfg.inequality_bound_multiplier, max=1.0)
        c = torch.where(fully_loc, 1.0,
                        torch.where(mixed | high_only, c_sampled,
                                    torch.where(insufficient, 0.0,
                                                c_mixed)))
    else:
        c = torch.where(fully_loc, 1.0, 0.0)
    return fully_loc, c.to(dtype), n_high


def detect_ternary(src_w, tgt, normals, H, mask, inequality,
                   cfg: XICPParamsConfig):
    """The equality / inequality (ternary) detector."""
    dtype = H.dtype
    V_rot, V_trans, _, _ = _eigen_analysis_3x3(H)
    w = mask.to(dtype)
    center = torch.sum(src_w * w[:, None], 0) / \
        torch.clamp(torch.sum(w), min=1.0)
    crosses = _crosses(src_w, normals, center)
    deltas = src_w - tgt
    loc_r, c_r, loc_t, c_t = [], [], [], []
    for i in range(3):
        lr, cr, n_high_rot = _ternary_one_subspace(
            crosses, V_rot[:, i], deltas, normals, src_w, mask, True,
            inequality, cfg)
        lt, ct, _ = _ternary_one_subspace(
            normals, V_trans[:, i], deltas, normals, src_w, mask, False,
            inequality, cfg)
        loc_r.append(lr)
        c_r.append(cr)
        loc_t.append(lt)
        c_t.append(ct)
    return XICPDetection(
        loc_rot=torch.stack(loc_r), loc_trans=torch.stack(loc_t),
        constraint_rot=torch.stack(c_r), constraint_trans=torch.stack(c_t),
        V_rot=V_rot, V_trans=V_trans,
        remap_P=torch.eye(6, dtype=dtype, device=H.device),
        n_high_rot=n_high_rot)


def detect_solution_remapping(H, cfg: XICPParamsConfig):
    """The solution-remapping detector: keep the eigen-directions whose
    singular value reaches the threshold; a dropped direction marks the
    rotation axis (if mostly rotation) or translation axis it leans on
    most."""
    dtype = H.dtype
    w, V = linalg.symmetric_eigh(H)
    sv, U = linalg.psd_svd_from_eigh(w, V)          # descending
    keep = sv >= cfg.solution_remapping_threshold
    P = torch.einsum('j,ij,kj->ik', keep.to(dtype), U, U)
    eye = torch.eye(6, dtype=dtype, device=H.device)
    P = torch.where(torch.linalg.norm(P) < 1e-6, eye, P)
    loc_rot = torch.ones(3, dtype=torch.bool, device=H.device)
    loc_trans = torch.ones(3, dtype=torch.bool, device=H.device)
    for i in range(6):
        dropped = ~keep[i]
        rot_c, trans_c = U[:3, i], U[3:, i]
        rot_major = torch.linalg.norm(rot_c) > 0.5
        hit_r = torch.arange(3, device=H.device) == torch.argmax(
            torch.abs(rot_c))
        hit_t = torch.arange(3, device=H.device) == torch.argmax(
            torch.abs(trans_c))
        loc_rot = loc_rot & ~(dropped & rot_major & hit_r)
        loc_trans = loc_trans & ~(dropped & ~rot_major & hit_t)
    V_rot, V_trans, _, _ = _eigen_analysis_3x3(H)
    return XICPDetection(
        loc_rot=loc_rot, loc_trans=loc_trans,
        constraint_rot=loc_rot.to(dtype),
        constraint_trans=loc_trans.to(dtype),
        V_rot=V_rot, V_trans=V_trans, remap_P=P,
        n_high_rot=torch.zeros((), dtype=torch.int32, device=H.device))


def _penalties(det: XICPDetection, cfg: XICPParamsConfig):
    """(active, weight, constraint value, direction in R^6) of the six
    direction constraints, in the reference's order (rotation i, then
    translation i, for i = 0, 1, 2)."""
    out = []
    for i in range(3):
        for loc, c_all, V, off in ((det.loc_rot, det.constraint_rot,
                                    det.V_rot, 0),
                                   (det.loc_trans, det.constraint_trans,
                                    det.V_trans, 3)):
            v6 = torch.zeros(6, dtype=V.dtype, device=V.device)
            v6[off:off + 3] = V[:, i]
            c = c_all[i]
            out.append((~loc[i], cfg.inequality_bound_multiplier * (1.0 - c),
                        c, v6))
    return out


def _solve_constraint(H, b, det: XICPDetection, inequality,
                      cfg: XICPParamsConfig):
    """One Ceres-LM step from zero (see the module docstring)."""
    H_aug, b_aug = H, b
    if not inequality:
        for active, wgt, c, v6 in _penalties(det, cfg):
            H_aug = H_aug + torch.where(active, wgt, 0.0) * torch.outer(v6,
                                                                        v6)
            b_aug = b_aug + torch.where(active, wgt * c, 0.0) * v6
    dx = linalg.solve_qr_6x6(H_aug + 1e-4 * torch.diag(torch.diagonal(H_aug)),
                             b_aug)
    if inequality:
        # Ceres' step acceptance: the inequality blocks shape no step
        # from zero, but the true cost at dx counts max(|v.dx| - c, 0);
        # rho = (model decrease - penalty) / model decrease, and a step
        # with rho <= 1e-3 is rejected (dx = 0)
        model_dec = b @ dx - 0.5 * (dx @ H @ dx)
        pen = torch.zeros((), dtype=H.dtype, device=H.device)
        for active, wgt, c, v6 in _penalties(det, cfg):
            over = torch.clamp(torch.abs(dx @ v6) - c, min=0.0)
            pen = pen + torch.where(active, 0.5 * wgt * over * over, 0.0)
        rho = (model_dec - pen) / torch.where(model_dec != 0.0, model_dec,
                                              1.0)
        dx = torch.where((model_dec > 0.0) & (rho > 1e-3), dx, 0.0)
    return dx


def _solve_projection(H, b, det: XICPDetection, use_remap_matrix):
    """SVD pseudo-inverse, then the projection."""
    w, V = linalg.symmetric_eigh(H)
    sv, U = linalg.psd_svd_from_eigh(w, V)
    big = sv > 1e-6
    inv = torch.where(big, 1.0 / torch.where(big, sv, torch.ones_like(sv)),
                      0.0)
    delta = U @ (inv * (U.T @ b))
    if use_remap_matrix:
        return det.remap_P @ delta
    d_rot, d_trans = delta[:3], delta[3:]
    for i in range(3):
        vr, vt = det.V_rot[:, i], det.V_trans[:, i]
        d_rot = d_rot - torch.where(det.loc_rot[i], 0.0, d_rot @ vr) * vr
        d_trans = d_trans - torch.where(det.loc_trans[i], 0.0,
                                        d_trans @ vt) * vt
    return torch.cat([d_rot, d_trans])


class XICPLoop(PairInputs):
    """One configuration of ``xicp_register`` split into the parts of its
    compiled loop over a ``graphs.State`` (as ``icp.PairLoop``):

      * ``load`` copies the per-call inputs: ``src``, ``R0``, ``t0``,
        ``T_gt``;
      * ``prologue`` the target normals (K2 at kk ``2 normal_k`` on the
        brute-force backend), the running count and error, the flags,
        ``H_last``, the empty log buffer and the iteration counter ``k``;
      * ``step`` one iteration, its packed log row written at ``k``
        through a comparison mask, and the ``done`` flag;
      * ``epilogue`` the covariance from ``H_last`` and the structured
        log.

    ``key()`` holds every static the parts bake in and the address and
    layout of the tensors they read in place (the target, the grid, the
    validity masks)."""

    name = "xicp_register"

    def __init__(self, target_xyz, N: int, detection: DetectionMethod,
                 handling: HandlingMethod, params: ICPParams,
                 xicp_cfg: XICPParamsConfig, target_valid, source_valid,
                 num_source, normal_k: int, grid, device, dtype):
        self.target, self.grid = target_xyz, grid
        self.target_valid, self.source_valid = target_valid, source_valid
        self.N, self.normal_k = N, normal_k
        self.denom = float(num_source if num_source is not None else N)
        self.detection, self.handling = detection, handling
        self.params, self.cfg = params, xicp_cfg
        self.dev, self.dtype = device, dtype

    def key(self) -> tuple:
        return (self.name, self.N, self.denom, self.normal_k, self.detection,
                self.handling, self.params, self.cfg, str(self.dtype),
                str(self.dev), graphs.tensor_key(
                    self.target, self.grid, self.target_valid,
                    self.source_valid))

    def prologue(self, S) -> None:
        dtype, dev = self.dtype, self.dev
        S.put("normals", estimate_normals(self.target, k=self.normal_k,
                                          valid=self.target_valid,
                                          chunk=self.params.chunk))
        zero = torch.zeros((), dtype=dtype, device=dev)
        false = torch.zeros((), dtype=torch.bool, device=dev)
        S.put("R", S.R0)
        S.put("t", S.t0)
        S.put("cum_cnt", zero)
        S.put("cum_err", zero)
        S.put("conv", false)
        S.put("abt", false)
        S.put("done", false)
        S.put("H_last", torch.eye(6, dtype=dtype, device=dev))
        S.put("buf", logpack.empty_buffer(self.params.max_iterations, dtype,
                                          dev))
        S.put("k", torch.zeros((), dtype=torch.int64, device=dev))

    def step(self, S) -> None:
        params, cfg, dtype = self.params, self.cfg, self.dtype
        detection = self.detection
        R, t = S.R, S.t
        src_w = S.src @ R.T + t
        sq_d, idx = nearest(src_w, self.target, self.target_valid,
                            params.chunk, self.grid)
        mask = sq_d < params.corr.search_radius ** 2
        if self.source_valid is not None:
            mask = mask & self.source_valid
        normals = S.normals[idx]
        tgt = self.target[idx]
        w = mask.to(dtype)
        # H = sum f f^T with f = [p x n; n]
        F = torch.cat([torch.linalg.cross(src_w, normals, dim=-1), normals],
                      dim=-1)
        Fw = F * w[:, None]
        H = Fw.T @ F
        dot = torch.sum((src_w - tgt) * normals, dim=-1)
        b = -(Fw.T @ dot)
        n_valid = torch.sum(mask)
        err_sum = torch.sum(w * dot * dot)
        cum_cnt = S.cum_cnt + n_valid.to(dtype)
        cum_err = S.cum_err + err_sum
        rmse = torch.sqrt(cum_err / torch.clamp(cum_cnt, min=1.0))
        fitness = cum_cnt / self.denom

        if detection == DetectionMethod.XICP_OPTIMIZED_EQUALITY:
            det = detect_optimized(src_w, normals, H, mask, cfg)
        elif detection in (DetectionMethod.XICP_EQUALITY,
                           DetectionMethod.XICP_INEQUALITY):
            det = detect_ternary(src_w, tgt, normals, H, mask,
                                 detection == DetectionMethod.XICP_INEQUALITY,
                                 cfg)
        else:
            det = detect_solution_remapping(H, cfg)
        if self.handling == HandlingMethod.XICP_CONSTRAINT:
            dx = _solve_constraint(
                H, b, det, detection == DetectionMethod.XICP_INEQUALITY, cfg)
        else:
            dx = _solve_projection(
                H, b, det,
                detection == DetectionMethod.XICP_SOLUTION_REMAPPING)

        too_few = n_valid < params.min_effective_points
        abort_now = too_few | ~torch.all(torch.isfinite(dx))
        dx = torch.where(abort_now, 0.0, dx)
        R_new, t_new = se3.boxplus_left(R, t, dx)
        R = torch.where(abort_now, R, R_new)
        t = torch.where(abort_now, t, t_new)
        T_new = se3.se3_matrix(R, t)
        te, re = se3.pose_error(S.T_gt, T_new)
        mask6 = torch.cat([~det.loc_rot, ~det.loc_trans])
        wf, _ = linalg.symmetric_eigh(H)
        row = logpack.pack_row(
            dtype, self.dev, executed=~too_few, effective_points=n_valid,
            corr_num=det.n_high_rot, rmse=rmse, fitness=fitness,
            objective=0.5 * err_sum, gradient=-b, dx=dx, transform=T_new,
            trans_error=te, rot_error_deg=re, eigenvalues_full=wf,
            singular_values=torch.flip(torch.abs(wf), (0,)),
            cond_full=linalg.condition_number(wf),
            is_degenerate=torch.any(mask6), degenerate_mask=mask6, H=H)
        S.put_row("buf", S.k, row, params.max_iterations)
        conv = (torch.linalg.norm(dx[:3]) < params.convergence_thresh_rot) \
            & (torch.linalg.norm(dx[3:]) < params.convergence_thresh_trans) \
            & ~abort_now
        S.put("R", R)
        S.put("t", t)
        S.put("cum_cnt", cum_cnt)
        S.put("cum_err", cum_err)
        S.put("H_last", torch.where(abort_now, S.H_last, H))
        S.put("conv", conv)
        S.put("abt", abort_now)
        S.put("k", S.k + 1)
        S.put("done", conv | abort_now)

    def epilogue(self, S) -> None:
        dtype, dev = self.dtype, self.dev
        w_h, V_h = linalg.symmetric_eigh(S.H_last)
        invertible = torch.amin(torch.abs(w_h)) > 1e-12
        w_inv = 1.0 / torch.where(torch.abs(w_h) > 1e-12, w_h,
                                  torch.ones_like(w_h))
        cov = (V_h * w_inv[None, :]) @ V_h.T
        S.put("cov", torch.where(S.conv & invertible, cov,
                                 1e6 * torch.eye(6, dtype=dtype, device=dev)))
        S.put("iterations", S.k.to(torch.int32))
        S.put_tuple("log", log_from_buffer(S.buf))

    def result(self, S) -> ICPResult:
        return ICPResult(R=S.R, t=S.t, converged=S.conv, aborted=S.abt,
                         iterations=S.iterations, covariance=S.cov,
                         log=S.get_tuple("log", IterationLog))


def xicp_register(source_xyz, target_xyz, R0, t0,
                  detection: DetectionMethod, handling: HandlingMethod,
                  params: ICPParams = ICPParams(),
                  xicp_cfg: XICPParamsConfig = XICPParamsConfig(),
                  T_gt=None, target_valid=None, source_valid=None,
                  num_source: int | None = None, normal_k: int = 5,
                  grid=None, device=None, graph=None) -> ICPResult:
    """X-ICP registration of one frame pair.  ``grid``: an optional
    GridIndex over the target (voxel >= search radius, validity baked in)
    in place of the brute 1-NN scan.  Runs on ``device`` (cuda unless
    told otherwise); on the card the loop's parts (``XICPLoop``) replay
    CUDA graphs, ``graph=False`` runs them eagerly, and on the CPU they
    run eagerly and ``graph=True`` raises (as ``icp_point_to_plane_so3``).
    """
    if grid is not None and target_valid is not None:
        raise ValueError("bake target_valid into the GridIndex instead")
    return run_pair_loop(
        lambda target, N, dev, dtype: XICPLoop(
            target, N, detection, handling, params, xicp_cfg, target_valid,
            source_valid, num_source, normal_k, grid, dev, dtype),
        source_xyz, target_xyz, R0, t0, T_gt, params.max_iterations, device,
        graph)
