"""Point-to-plane ICP (counterpart of ``dcreg_tpu/models/icp.py``): the
pair-mode SO(3) engine ``icp_point_to_plane_so3`` and the pieces it
shares with the batched engine.

Two-pass design as in the JAX module: the optimisation loop records a
minimal per-iteration ``Hist`` (the 6x6 system plus scalar stats), and the
full per-iteration telemetry is reconstructed from it afterwards as one
batched pass over the iterations (and the lanes, in the batched engine).
The JAX ``jit`` over a ``while_loop`` is a prologue, a step and an
epilogue over fixed state tensors (``PairLoop``), captured as CUDA graphs
on the card and replayed (``graphs``); the host reads the done flag
(converged | aborted) once per step.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .. import graphs
from ..ops import linalg, se3
from ..ops.correspondence import CorrespondenceParams, find_correspondences
from ..ops.degeneracy import (DegeneracyThresholds, DetectionMethod,
                              HandlingMethod, analyze)
from ..ops.gauss_newton import build_system
from ..ops.solvers import solve
from ..utils import check_precise, resolve_device


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


def log_from_buffer(buf) -> IterationLog:
    """The structured IterationLog of a packed (I, ROW_SIZE) buffer, as
    the engines that log inline (XICP, O3D) write it."""
    from . import logpack
    return IterationLog(**{name: logpack.unpack(buf, name)
                           for name in IterationLog._fields})


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


class ICPResult(NamedTuple):
    R: torch.Tensor           # (3, 3) final rotation
    t: torch.Tensor           # (3,) final translation
    converged: torch.Tensor   # () bool
    aborted: torch.Tensor     # () bool (too few points / non-finite dx)
    iterations: torch.Tensor  # () int32
    covariance: torch.Tensor  # (6, 6) repaired H^-1, 1e6 I unless converged
    log: IterationLog         # (I, ...) fields


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
    R_new, t_new = se3.boxplus(h.R, h.t, h.dx)
    return log_rows(h, executed, h.num_valid < min_effective_points, h.dx,
                    se3.se3_matrix(R_new, t_new), T_gt, analysis, sinfo)


def log_rows(h, executed, too_few, dx, T_new, T_gt, ana,
             sinfo) -> IterationLog:
    """The log of recorded iterations: ``h``'s H, g, num_valid, rmse,
    fitness and objective, the applied ``dx``, the pose ``T_new`` after
    it (errors against ``T_gt``), the analysis ``ana`` and the solver
    extras ``sinfo``; rows where ``executed`` is False are NaN / 0 / -1."""
    te, re = se3.pose_error(T_gt.expand(T_new.shape), T_new)

    def nanify(x):
        e = executed.reshape(executed.shape
                             + (1,) * (x.ndim - executed.ndim))
        return torch.where(e, x, float("nan"))

    return IterationLog(
        executed=executed & ~too_few,
        effective_points=torch.where(executed, h.num_valid, 0).to(
            torch.int32),
        corr_num=torch.where(executed, h.num_valid, 0).to(torch.int32),
        rmse=nanify(h.rmse), fitness=nanify(h.fitness),
        objective=nanify(h.objective),
        gradient=nanify(-h.g), dx=nanify(dx), transform=nanify(T_new),
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


class PairInputs:
    """What the loops of the pair engines (``PairLoop``, ``EulerLoop``,
    ``XICPLoop``, ``O3DLoop``, ``SuperLocLoop``) share: ``load`` copies
    the per-call inputs into the state (source ``src``, ``R0``, ``t0``,
    ``T_gt``)."""

    def load(self, S, source_xyz, R0, t0, T_gt) -> None:
        S.put("src", source_xyz)
        S.put("R0", R0)
        S.put("t0", t0)
        S.put("T_gt", T_gt)


class PairLoop(PairInputs):
    """One configuration of ``icp_point_to_plane_so3`` split into the
    parts of its compiled loop, each reading and writing a
    ``graphs.State`` in place:

      * ``load`` copies the per-call inputs into the state: source
        ``src``, ``R0``, ``t0``, ``T_gt``;
      * ``prologue`` the loop state: the pose, the flags, the empty
        history and the device-side iteration counter ``k``;
      * ``step`` one iteration (``iterate``), the history row ``k``
        written through a comparison mask, the pose update and the
        ``done`` flag the host reads once per step;
      * ``epilogue`` ``H_last`` gathered at ``k - 1``, the telemetry
        pass (or the empty log) and the covariance.

    ``key()`` holds every static the parts bake in, and the address and
    layout of the tensors they read in place (the target, the search
    index, the validity masks)."""

    name = "icp_point_to_plane_so3"

    def __init__(self, target_xyz, N: int, detection: DetectionMethod,
                 handling: HandlingMethod, params: ICPParams, target_valid,
                 source_valid, num_source, grid, device, dtype):
        self.target, self.grid = target_xyz, grid
        self.target_valid, self.source_valid = target_valid, source_valid
        self.N, self.num_source = N, num_source
        self.detection, self.handling, self.params = detection, handling, \
            params
        self.fast = (detection is DetectionMethod.SCHUR_CONDITION_NUMBER and
                     handling is HandlingMethod.PRECONDITIONED_CG)
        self.dev, self.dtype = device, dtype

    def key(self) -> tuple:
        return (self.name, self.N, self.num_source,
                self.detection, self.handling, self.params, str(self.dtype),
                str(self.dev), graphs.tensor_key(
                    self.target, self.grid, self.target_valid,
                    self.source_valid))

    def prologue(self, S) -> None:
        dev = self.dev
        false = torch.zeros((), dtype=torch.bool, device=dev)
        S.put("R", S.R0)
        S.put("t", S.t0)
        S.put("conv", false)
        S.put("abt", false)
        S.put("done", false)
        S.put("k", torch.zeros((), dtype=torch.int64, device=dev))
        S.put_tuple("hist", empty_hist(self.params.max_iterations,
                                       self.dtype, device=dev))

    def iterate(self, S):
        """One ICP iteration at the state's pose: (system, dx,
        abort_now)."""
        params = self.params
        corr = find_correspondences(S.src, S.R, S.t, self.target,
                                    target_valid=self.target_valid,
                                    source_valid=self.source_valid,
                                    params=params.corr, chunk=params.chunk,
                                    grid=self.grid)
        sysm = build_system(S.src, S.R, S.t, corr, num_source=self.num_source,
                            use_weight_derivative=params.use_weight_derivative,
                            weight_slope=params.corr.weight_slope)
        analysis = analyze(sysm.H, self.detection, params.thresholds,
                           fast=self.fast)
        dx, _ = solve(sysm.H, sysm.g, self.handling, analysis,
                      params.thresholds, telemetry=False, fast=self.fast)
        too_few = sysm.num_valid < params.min_effective_points
        abort_now = too_few | ~torch.all(torch.isfinite(dx))
        return sysm, torch.where(abort_now, 0.0, dx), abort_now

    def step(self, S) -> None:
        params = self.params
        sysm, dx, abort_now = self.iterate(S)
        for name, value in (("R", S.R), ("t", S.t), ("H", sysm.H),
                            ("g", sysm.g), ("dx", dx),
                            ("num_valid", sysm.num_valid.to(torch.int32)),
                            ("rmse", sysm.rmse), ("fitness", sysm.fitness),
                            ("objective", sysm.objective)):
            S.put_row(f"hist.{name}", S.k, value, params.max_iterations)
        R_new, t_new = se3.boxplus(S.R, S.t, dx)
        conv = (torch.linalg.norm(dx[:3]) < params.convergence_thresh_rot) \
            & (torch.linalg.norm(dx[3:]) < params.convergence_thresh_trans) \
            & ~abort_now
        S.put("R", torch.where(abort_now, S.R, R_new))
        S.put("t", torch.where(abort_now, S.t, t_new))
        S.put("conv", conv)
        S.put("abt", abort_now)
        S.put("k", S.k + 1)
        S.put("done", conv | abort_now)

    def epilogue(self, S) -> None:
        params, dtype = self.params, self.dtype
        I = params.max_iterations
        hist = S.get_tuple("hist", Hist)
        last = torch.clamp(S.k - 1, min=0).reshape(1)
        H_last = hist.H.index_select(0, last)[0]
        if params.full_telemetry:
            executed = torch.arange(I, device=self.dev) < S.k
            log = telemetry_row(hist, executed, self.detection,
                                self.handling, params.thresholds,
                                params.min_effective_points, S.T_gt)
        else:
            log = _empty_log(I, dtype, device=self.dev)
        S.put_tuple("log", log)
        S.put("cov", covariance_from_H(H_last, S.conv, dtype))
        S.put("iterations", S.k.to(torch.int32))

    def result(self, S) -> ICPResult:
        return ICPResult(R=S.R, t=S.t, converged=S.conv, aborted=S.abt,
                         iterations=S.iterations, covariance=S.cov,
                         log=S.get_tuple("log", IterationLog))


def icp_point_to_plane_so3(source_xyz, target_xyz, R0, t0,
                           detection: DetectionMethod,
                           handling: HandlingMethod,
                           params: ICPParams = ICPParams(),
                           T_gt=None, target_valid=None, source_valid=None,
                           num_source: int | None = None,
                           grid=None, device=None, graph=None) -> ICPResult:
    """Run the SO(3) point-to-plane ICP of one frame pair to convergence.

    source_xyz (N, 3) body frame, target_xyz (M, 3) map frame, (R0, t0)
    initial pose; the dtype is the source's (f32 or f64).  ``grid``: the
    search backend of ``find_correspondences`` (None = brute force, or a
    GridIndex / BlockIndex built once per target).  The DCReg pair
    (SCHUR_CONDITION_NUMBER, PRECONDITIONED_CG) takes the in-loop fast
    path: closed-form 3x3 Schur spectra and Cholesky/PCG, the 6x6 spectra
    only in the telemetry pass.  An iteration with fewer than
    ``min_effective_points`` correspondences or a non-finite update
    aborts without moving; convergence is tested after the update.

    Runs on ``device`` (cuda unless told otherwise).  On the card the
    loop's parts (``PairLoop``) run as CUDA graphs, captured at the first
    call of their statics and replayed after (``graphs.CACHE``; the
    target, the index and the masks are read in place, so a call with the
    same tensors replays); ``graph=False`` runs them eagerly, for
    checking only; on the CPU they run eagerly and ``graph=True``
    raises."""
    return run_pair_loop(
        lambda target, N, dev, dtype: PairLoop(
            target, N, detection, handling, params, target_valid,
            source_valid, num_source, grid, dev, dtype),
        source_xyz, target_xyz, R0, t0, T_gt, params.max_iterations, device,
        graph)


def run_pair_loop(make, source_xyz, target_xyz, R0, t0, T_gt,
                  max_iterations: int, device, graph):
    """A pair engine's call: the inputs on ``device`` in the source's
    dtype, one pass of the loop ``make(target, N, device, dtype)`` makes
    (``PairLoop``, ``EulerLoop``, ``XICPLoop``, ``O3DLoop``,
    ``SuperLocLoop``: a ``load(S, source, R0, t0, T_gt)``, its parts and
    ``result(S)``), replayed as graphs or run eagerly as ``graph`` and
    the device say, and its result (copied out of a graph's state)."""
    check_precise()
    dev = resolve_device(device)
    graphed = graphs.use_graphs(dev, graph)
    source_xyz = torch.as_tensor(source_xyz, device=dev)
    dtype = source_xyz.dtype
    as_dev = lambda x: torch.as_tensor(x, dtype=dtype, device=dev)
    target_xyz = as_dev(target_xyz)
    R0, t0 = as_dev(R0), as_dev(t0)
    T_gt = torch.eye(4, dtype=dtype, device=dev) if T_gt is None \
        else as_dev(T_gt)
    loop = make(target_xyz, source_xyz.shape[0], dev, dtype)
    run, S = graphs.bind(
        loop, lambda S: loop.load(S, source_xyz, R0, t0, T_gt), graphed,
        loop.name, dev)
    graphs.drive(run, S, max_iterations)
    return graphs.detached(loop.result(S)) if graphed else loop.result(S)
