"""Shared pieces of the point-to-plane ICP engines (counterpart of
``dcreg_tpu/models/icp.py``; the pair-mode engine
``icp_point_to_plane_so3`` is not ported yet).

Two-pass design as in the JAX module: the optimisation loop records a
minimal per-iteration ``Hist`` (the 6x6 system plus scalar stats), and the
full per-iteration telemetry is reconstructed from it afterwards as one
batched pass over (lanes, iterations).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops import linalg, se3
from ..ops.correspondence import CorrespondenceParams
from ..ops.degeneracy import DegeneracyThresholds, analyze
from ..ops.solvers import solve


class ICPParams(NamedTuple):
    max_iterations: int = 30
    convergence_thresh_trans: float = 1e-3
    convergence_thresh_rot: float = 1e-4
    min_effective_points: int = 10
    use_weight_derivative: bool = True
    corr: CorrespondenceParams = CorrespondenceParams()
    thresholds: DegeneracyThresholds = DegeneracyThresholds()
    chunk: int = 2048
    full_telemetry: bool = True
    telemetry_iter_group: int = 4


class IterationLog(NamedTuple):
    """Stacked per-iteration telemetry; row k valid iff executed[k].
    Leading dims (..., I)."""
    executed: torch.Tensor
    effective_points: torch.Tensor
    corr_num: torch.Tensor
    rmse: torch.Tensor
    fitness: torch.Tensor
    objective: torch.Tensor
    gradient: torch.Tensor
    dx: torch.Tensor
    transform: torch.Tensor
    trans_error: torch.Tensor
    rot_error_deg: torch.Tensor
    eigenvalues_full: torch.Tensor
    singular_values: torch.Tensor
    lambda_schur_rot: torch.Tensor
    lambda_schur_trans: torch.Tensor
    V_schur_rot: torch.Tensor
    V_schur_trans: torch.Tensor
    lambda_diag_rot: torch.Tensor
    lambda_diag_trans: torch.Tensor
    cond_full: torch.Tensor
    cond_schur_rot: torch.Tensor
    cond_schur_trans: torch.Tensor
    cond_diag_rot: torch.Tensor
    cond_diag_trans: torch.Tensor
    cond_full_sub_rot: torch.Tensor
    cond_full_sub_trans: torch.Tensor
    is_degenerate: torch.Tensor
    degenerate_mask: torch.Tensor
    pcg_iterations: torch.Tensor
    pcg_residual: torch.Tensor
    cond_PH: torch.Tensor
    P_preconditioner: torch.Tensor
    W_adaptive: torch.Tensor
    H: torch.Tensor


_LOG_TRAILING = {
    "gradient": (6,), "dx": (6,), "transform": (4, 4),
    "eigenvalues_full": (6,), "singular_values": (6,),
    "lambda_schur_rot": (3,), "lambda_schur_trans": (3,),
    "V_schur_rot": (3, 3), "V_schur_trans": (3, 3),
    "lambda_diag_rot": (3,), "lambda_diag_trans": (3,),
    "degenerate_mask": (6,), "P_preconditioner": (6, 6),
    "W_adaptive": (6, 6), "H": (6, 6)}


def _empty_log(I, dtype, lead=(), device=None) -> IterationLog:
    """The all-unexecuted log: NaN floats, False flags, 0 counts, -1 PCG
    iterations."""
    fields = {}
    for name in IterationLog._fields:
        shape = lead + (I,) + _LOG_TRAILING.get(name, ())
        if name in ("executed", "is_degenerate", "degenerate_mask"):
            fields[name] = torch.zeros(shape, dtype=torch.bool, device=device)
        elif name in ("effective_points", "corr_num"):
            fields[name] = torch.zeros(shape, dtype=torch.int32,
                                       device=device)
        elif name == "pcg_iterations":
            fields[name] = torch.full(shape, -1, dtype=torch.int32,
                                      device=device)
        else:
            fields[name] = torch.full(shape, float("nan"), dtype=dtype,
                                      device=device)
    return IterationLog(**fields)


class Hist(NamedTuple):
    """Per-iteration minimal state recorded by the loop; dims (..., I)."""
    R: torch.Tensor          # (..., I, 3, 3) pose BEFORE iteration k
    t: torch.Tensor          # (..., I, 3)
    H: torch.Tensor          # (..., I, 6, 6)
    g: torch.Tensor          # (..., I, 6)
    dx: torch.Tensor         # (..., I, 6) the applied update
    num_valid: torch.Tensor  # (..., I) int32
    rmse: torch.Tensor
    fitness: torch.Tensor
    objective: torch.Tensor


def empty_hist(I, dtype, lead=(), device=None) -> Hist:
    z = lambda *s: torch.zeros(lead + (I,) + s, dtype=dtype, device=device)
    nan = lambda: torch.full(lead + (I,), float("nan"), dtype=dtype,
                             device=device)
    return Hist(R=z(3, 3), t=z(3), H=z(6, 6), g=z(6), dx=z(6),
                num_valid=torch.zeros(lead + (I,), dtype=torch.int32,
                                      device=device),
                rmse=nan(), fitness=nan(), objective=nan())


def telemetry_row(h: Hist, executed, detection, handling, thresholds,
                  min_effective_points, T_gt) -> IterationLog:
    """Reconstruct the full per-iteration log from the recorded minimal
    state, batched over every leading dimension of ``h`` (``executed``
    has those dims).  dx/transform/errors use the recorded applied
    update; spectra and solver extras are recomputed with the generic
    (non-fast) analysis and solve."""
    analysis = analyze(h.H, detection, thresholds)
    _, sinfo = solve(h.H, h.g, handling, analysis, thresholds,
                     telemetry=True)
    too_few = h.num_valid < min_effective_points
    R_new, t_new = se3.boxplus(h.R, h.t, h.dx)
    T_new = se3.se3_matrix(R_new, t_new)
    te, re = se3.pose_error(T_gt.expand(T_new.shape), T_new)

    def nanify(x):
        e = executed.reshape(executed.shape
                             + (1,) * (x.ndim - executed.ndim))
        return torch.where(e, x, float("nan"))

    ana = analysis
    return IterationLog(
        executed=executed & ~too_few,
        effective_points=torch.where(executed, h.num_valid, 0).to(
            torch.int32),
        corr_num=torch.where(executed, h.num_valid, 0).to(torch.int32),
        rmse=nanify(h.rmse), fitness=nanify(h.fitness),
        objective=nanify(h.objective),
        gradient=nanify(-h.g), dx=nanify(h.dx), transform=nanify(T_new),
        trans_error=nanify(te), rot_error_deg=nanify(re),
        eigenvalues_full=nanify(ana.eigenvalues_full),
        singular_values=nanify(ana.singular_values),
        lambda_schur_rot=nanify(ana.lambda_schur_rot),
        lambda_schur_trans=nanify(ana.lambda_schur_trans),
        V_schur_rot=nanify(ana.V_schur_rot),
        V_schur_trans=nanify(ana.V_schur_trans),
        lambda_diag_rot=nanify(ana.lambda_diag_rot),
        lambda_diag_trans=nanify(ana.lambda_diag_trans),
        cond_full=nanify(ana.cond_full),
        cond_schur_rot=nanify(ana.cond_schur_rot),
        cond_schur_trans=nanify(ana.cond_schur_trans),
        cond_diag_rot=nanify(ana.cond_diag_rot),
        cond_diag_trans=nanify(ana.cond_diag_trans),
        cond_full_sub_rot=nanify(ana.cond_full_sub_rot),
        cond_full_sub_trans=nanify(ana.cond_full_sub_trans),
        is_degenerate=ana.is_degenerate & executed,
        degenerate_mask=ana.degenerate_mask & executed[..., None],
        pcg_iterations=torch.where(executed, sinfo.pcg_iterations, -1).to(
            torch.int32),
        pcg_residual=nanify(sinfo.pcg_residual),
        cond_PH=nanify(sinfo.cond_PH),
        P_preconditioner=nanify(sinfo.P_preconditioner),
        W_adaptive=nanify(sinfo.W_adaptive),
        H=nanify(h.H))


def covariance_from_H(H_last, converged, dtype):
    """Repaired H^-1 covariance where converged, 1e6 I otherwise; batched
    over the leading dims of H_last."""
    w_h, V_h = linalg.symmetric_eigh(H_last)
    invertible = torch.amin(torch.abs(w_h), dim=-1) > 1e-12
    w_inv = 1.0 / torch.where(torch.abs(w_h) > 1e-12, w_h,
                              torch.ones_like(w_h))
    cov_inv = (V_h * w_inv[..., None, :]) @ V_h.transpose(-1, -2)
    w_c, V_c = linalg.symmetric_eigh(cov_inv)
    needs_repair = torch.amin(w_c, dim=-1) <= 1e-12
    w_rep = torch.clamp(w_c, min=1e-9)
    cov_rep = (V_c * w_rep[..., None, :]) @ V_c.transpose(-1, -2)
    cov = torch.where(needs_repair[..., None, None], cov_rep, cov_inv)
    eye = torch.eye(6, dtype=dtype, device=H_last.device)
    return torch.where((converged & invertible)[..., None, None], cov,
                       1e6 * eye)
