"""Degeneracy analysis of the 6x6 GN Hessian (counterpart of
``dcreg_tpu/ops/degeneracy.py``).

Full / diagonal-block / Schur-complement spectra, the detection masks and
the DCReg targeted preconditioner, batched over leading dimensions (the
telemetry pass analyses (B, I) Hessians at once).  The detection method is
a static enum; the JAX module's traced int codes exist only to cover the
method matrix with one XLA compile and have no counterpart here.
"""
from __future__ import annotations

import enum
from typing import NamedTuple

import torch

from . import linalg


class DetectionMethod(enum.Enum):
    NONE = "NONE_DETE"
    FULL_EVD_MIN_EIGENVALUE = "FULL_EVD_MIN_EIGENVALUE"
    EVD_SUB_CONDITION = "EVD_SUB_CONDITION"
    FULL_SVD_CONDITION = "FULL_SVD_CONDITION"
    SCHUR_CONDITION_NUMBER = "SCHUR_CONDITION_NUMBER"
    XICP_SOLUTION_REMAPPING = "XICP_SOLUTION_REMAPPING"
    XICP_OPTIMIZED_EQUALITY = "XICP_OPTIMIZED_EQUALITY"
    XICP_EQUALITY = "XICP_EQUALITY"
    XICP_INEQUALITY = "XICP_INEQUALITY"
    SUPERLOC = "SUPERLOC"
    O3D = "O3D"


class HandlingMethod(enum.Enum):
    NONE = "NONE_HAND"
    SOLUTION_REMAPPING = "SOLUTION_REMAPPING"
    TRUNCATED_SVD = "TRUNCATED_SVD"
    STANDARD_REGULARIZATION = "STANDARD_REGULARIZATION"
    ADAPTIVE_REGULARIZATION = "ADAPTIVE_REGULARIZATION"
    PRECONDITIONED_CG = "PRECONDITIONED_CG"
    XICP_PROJECTION = "XICP_PROJECTION"
    XICP_CONSTRAINT = "XICP_CONSTRAINT"
    SUPERLOC = "SUPERLOC"
    O3D = "O3D"


class DegeneracyThresholds(NamedTuple):
    cond_thresh: float = 10.0
    eig_thresh: float = 120.0
    std_reg_gamma: float = 100.0
    kappa_target: float = 10.0
    pcg_tolerance: float = 1e-6
    pcg_max_iter: int = 10
    adaptive_reg_alpha: float = 10.0


class DegeneracyAnalysis(NamedTuple):
    """Every field carries the leading batch dimensions of H."""
    eigenvalues_full: torch.Tensor     # (..., 6) ascending
    eigenvectors_full: torch.Tensor    # (..., 6, 6) columns
    singular_values: torch.Tensor      # (..., 6) descending
    cond_full: torch.Tensor
    cond_full_sub_rot: torch.Tensor
    cond_full_sub_trans: torch.Tensor
    lambda_diag_rot: torch.Tensor      # (..., 3)
    lambda_diag_trans: torch.Tensor
    cond_diag_rot: torch.Tensor
    cond_diag_trans: torch.Tensor
    lambda_schur_rot: torch.Tensor     # (..., 3)
    lambda_schur_trans: torch.Tensor
    V_schur_rot: torch.Tensor          # (..., 3, 3)
    V_schur_trans: torch.Tensor
    cond_schur_rot: torch.Tensor
    cond_schur_trans: torch.Tensor
    schur_valid: torch.Tensor          # (...,) bool
    is_degenerate: torch.Tensor        # (...,) bool
    degenerate_mask: torch.Tensor      # (..., 6) bool, [rot(3) | trans(3)]


_EPS = 1e-12
_DET_REL_EPS = 1e-10


def _block_diag(A, B):
    """blockdiag(A, B) of two (..., 3, 3) batches."""
    Z = torch.zeros_like(A)
    return torch.cat([torch.cat([A, Z], dim=-1),
                      torch.cat([Z, B], dim=-1)], dim=-2)


def _eye6_like(H):
    return torch.eye(6, dtype=H.dtype, device=H.device).expand(
        H.shape[:-2] + (6, 6))


def analyze(H, method: DetectionMethod,
            thresholds: DegeneracyThresholds = DegeneracyThresholds(),
            fast: bool = False) -> DegeneracyAnalysis:
    """Spectral analysis + detection mask of (..., 6, 6) GN Hessians.

    ``fast=True`` (only with SCHUR_CONDITION_NUMBER) skips the 6x6
    eigendecomposition (those fields are NaN) and takes the closed-form
    3x3 eigensolver for the Schur blocks."""
    dtype, dev = H.dtype, H.device
    batch = H.shape[:-2]
    fast = fast and method is DetectionMethod.SCHUR_CONDITION_NUMBER
    if fast:
        w_full = torch.full(batch + (6,), float("nan"), dtype=dtype,
                            device=dev)
        V_full = torch.full(batch + (6, 6), float("nan"), dtype=dtype,
                            device=dev)
    else:
        w_full, V_full = linalg.symmetric_eigh(H)
    sv, _ = linalg.psd_svd_from_eigh(w_full, V_full)
    inf = float("inf")
    cond_full = torch.where(sv[..., 5] > _EPS,
                            sv[..., 0] / torch.clamp(sv[..., 5], min=_EPS),
                            inf)
    cond_sub_trans = torch.abs(w_full[..., 2]) / torch.clamp(
        torch.abs(w_full[..., 0]), min=_EPS)
    cond_sub_rot = torch.abs(w_full[..., 5]) / torch.clamp(
        torch.abs(w_full[..., 3]), min=_EPS)

    H_RR = H[..., :3, :3]
    H_tt = H[..., 3:, 3:]
    H_Rt = H[..., :3, 3:]
    H_tR = H[..., 3:, :3]
    inv_tt, det_tt = linalg.inv_3x3(H_tt)
    inv_rr, det_rr = linalg.inv_3x3(H_RR)
    scale_tt = torch.amax(torch.abs(H_tt), dim=(-2, -1)) ** 3 + _EPS
    scale_rr = torch.amax(torch.abs(H_RR), dim=(-2, -1)) ** 3 + _EPS
    invertible = (torch.abs(det_tt) > _DET_REL_EPS * scale_tt) & \
                 (torch.abs(det_rr) > _DET_REL_EPS * scale_rr)
    S_R = H_RR - H_Rt @ inv_tt @ H_tR
    S_t = H_tt - H_tR @ inv_rr @ H_Rt

    eig3 = linalg.eigh3_closed if fast else linalg.symmetric_eigh
    w3, V3 = eig3(torch.stack([H_RR, H_tt, S_R, S_t], dim=-3))
    w_diag_rot, w_diag_trans = w3[..., 0, :], w3[..., 1, :]
    cond_diag_rot = linalg.condition_number(w_diag_rot)
    cond_diag_trans = linalg.condition_number(w_diag_trans)
    w_schur_rot, V_schur_rot = w3[..., 2, :], V3[..., 2, :, :]
    w_schur_trans, V_schur_trans = w3[..., 3, :], V3[..., 3, :, :]
    cond_schur_rot = torch.where(
        invertible, linalg.condition_number(w_schur_rot), inf)
    cond_schur_trans = torch.where(
        invertible, linalg.condition_number(w_schur_trans), inf)
    w_schur_rot = torch.where(invertible[..., None], w_schur_rot,
                              float("nan"))
    w_schur_trans = torch.where(invertible[..., None], w_schur_trans,
                                float("nan"))

    ct = thresholds.cond_thresh
    et = thresholds.eig_thresh
    false6 = torch.zeros(batch + (6,), dtype=torch.bool, device=dev)
    if method is DetectionMethod.FULL_EVD_MIN_EIGENVALUE:
        mask = w_full < et
        is_degen = torch.any(mask, dim=-1)
    elif method is DetectionMethod.EVD_SUB_CONDITION:
        rot_bad = cond_diag_rot > ct
        trans_bad = cond_diag_trans > ct
        is_degen = rot_bad | trans_bad
        mask = torch.cat([rot_bad[..., None].expand(batch + (3,)),
                          trans_bad[..., None].expand(batch + (3,))], dim=-1)
    elif method is DetectionMethod.FULL_SVD_CONDITION:
        is_degen = cond_full > ct
        ratios = w_full[..., 5:6] / torch.where(torch.abs(w_full) > _EPS,
                                                w_full, _EPS)
        mask = torch.where(is_degen[..., None],
                           (ratios > ct) | (torch.abs(w_full) <= _EPS),
                           false6)
    elif method is DetectionMethod.SCHUR_CONDITION_NUMBER:
        rot_bad = cond_schur_rot > ct
        trans_bad = cond_schur_trans > ct
        is_degen = rot_bad | trans_bad
        rot_ratio = w_schur_rot[..., 2:3] / torch.clamp(w_schur_rot,
                                                        min=_EPS)
        trans_ratio = w_schur_trans[..., 2:3] / torch.clamp(w_schur_trans,
                                                            min=_EPS)
        mask = torch.cat([rot_bad[..., None] & (rot_ratio > ct),
                          trans_bad[..., None] & (trans_ratio > ct)], dim=-1)
    else:
        # NONE and the engine-level methods (XICP_*, SUPERLOC, O3D) map
        # to detection code 0 in the JAX module
        mask = false6
        is_degen = torch.zeros(batch, dtype=torch.bool, device=dev)

    return DegeneracyAnalysis(
        eigenvalues_full=w_full, eigenvectors_full=V_full,
        singular_values=sv, cond_full=cond_full,
        cond_full_sub_rot=cond_sub_rot, cond_full_sub_trans=cond_sub_trans,
        lambda_diag_rot=w_diag_rot, lambda_diag_trans=w_diag_trans,
        cond_diag_rot=cond_diag_rot, cond_diag_trans=cond_diag_trans,
        lambda_schur_rot=w_schur_rot, lambda_schur_trans=w_schur_trans,
        V_schur_rot=V_schur_rot, V_schur_trans=V_schur_trans,
        cond_schur_rot=cond_schur_rot, cond_schur_trans=cond_schur_trans,
        schur_valid=invertible, is_degenerate=is_degen,
        degenerate_mask=mask)


class AlignmentInfo(NamedTuple):
    order: torch.Tensor       # (..., 3) raw eigenvector column at axis i
    lambdas: torch.Tensor     # (..., 3)
    angles_deg: torch.Tensor  # (..., 3)
    percents: torch.Tensor    # (..., 3, 3)
    V_aligned: torch.Tensor   # (..., 3, 3)


def align_to_axes(V, lam) -> AlignmentInfo:
    """Greedy axis assignment of an orthonormal eigenbasis: axis i takes
    the unassigned column with the largest |V[i, col]| (first on ties)."""
    absV = torch.abs(V)
    taken = torch.zeros(V.shape[:-2] + (3,), dtype=torch.bool,
                        device=V.device)
    cols = []
    for axis in range(3):
        scores = torch.where(taken, float("-inf"), absV[..., axis, :])
        col = torch.argmax(scores, dim=-1)
        taken = taken | (col[..., None] == torch.arange(3,
                                                        device=V.device))
        cols.append(col)
    order = torch.stack(cols, dim=-1)
    V_perm = torch.gather(V, -1, order[..., None, :].expand(V.shape))
    lam_perm = torch.gather(lam, -1, order)
    diag = torch.diagonal(V_perm, dim1=-2, dim2=-1)
    angles = torch.rad2deg(torch.arccos(torch.clamp(torch.abs(diag), 0.0,
                                                    1.0)))
    absVp = torch.abs(V_perm)
    percents = (100.0 * absVp / torch.sum(absVp, dim=-2, keepdim=True)
                ).transpose(-1, -2)
    signs = torch.sign(diag)
    signs = torch.where(signs == 0, torch.ones_like(signs), signs)
    return AlignmentInfo(order=order, lambdas=lam_perm, angles_deg=angles,
                         percents=percents,
                         V_aligned=V_perm * signs[..., None, :])


def targeted_preconditioner(analysis: DegeneracyAnalysis,
                            kappa_target: float):
    """DCReg's targeted preconditioner: per 3x3 Schur subspace,
    V diag(1 / max(lam, lam_max / kappa)) V^T; identity where the Schur
    complement was not computable."""
    def block(lam, V):
        lam_c = torch.maximum(lam, lam[..., 2:3] / kappa_target)
        return (V * (1.0 / lam_c)[..., None, :]) @ V.transpose(-1, -2)

    P = _block_diag(block(analysis.lambda_schur_rot, analysis.V_schur_rot),
                    block(analysis.lambda_schur_trans,
                          analysis.V_schur_trans))
    ok = analysis.schur_valid & torch.all(torch.isfinite(P), dim=(-2, -1))
    return torch.where(ok[..., None, None], P, _eye6_like(P))


def preconditioner_axis_aligned_view(analysis: DegeneracyAnalysis,
                                     kappa_target: float):
    """The targeted preconditioner with each 3x3 block's rows and columns
    permuted into axis-aligned order (``align_to_axes``): the convention
    of the recorded "Ours" P block.  The PCG solve itself uses the
    world-frame ``targeted_preconditioner``; this view is for writers."""
    P = targeted_preconditioner(analysis, kappa_target)

    def permuted(B, V, lam):
        o = align_to_axes(V, lam).order                 # (..., 3)
        rows = torch.gather(B, -2, o[..., :, None].expand(B.shape))
        return torch.gather(rows, -1, o[..., None, :].expand(B.shape))

    return _block_diag(
        permuted(P[..., :3, :3], analysis.V_schur_rot,
                 analysis.lambda_schur_rot),
        permuted(P[..., 3:, 3:], analysis.V_schur_trans,
                 analysis.lambda_schur_trans))


def adaptive_regularizer(analysis: DegeneracyAnalysis, alpha: float):
    """ME-AReg: V diag(relu(lam_max / alpha - lam)) V^T per Schur block;
    zero where the Schur complement was not computable."""
    def block(lam, V):
        boost = torch.clamp(lam[..., 2:3] / alpha - lam, min=0.0)
        return (V * boost[..., None, :]) @ V.transpose(-1, -2)

    W = _block_diag(block(analysis.lambda_schur_rot, analysis.V_schur_rot),
                    block(analysis.lambda_schur_trans,
                          analysis.V_schur_trans))
    ok = analysis.schur_valid & torch.all(torch.isfinite(W), dim=(-2, -1))
    return torch.where(ok[..., None, None], W, torch.zeros_like(W))
