"""Scan-to-map odometry (counterpart of ``dcreg_tpu/models/odometry.py``).

Two loops share the frame chain, a constant-velocity motion-model seed
projected back onto SO(3) every frame; the JAX ``lax.scan`` over frames
is a Python loop here, over the replays of each frame's CUDA graphs on
the card (``VoxelLoop``, ``MapLoop``):

  * ``run_odometry``, the voxel-grid loop: the map indexed once by
    ``build_voxel_grid``, and per frame a fixed-trip masked DCReg ICP
    whose search is ``voxel_knn``; any float dtype;
  * ``run_odometry_map``, the map-scale localization loop: one B = 1
    map-mode DCReg registration with a single reused pair list per frame
    (``icp_batch_so3``), float32;
  * ``run_odometry_fleet``, one tick of that loop for a fleet of S
    sensors against one map: one batched map-mode registration whose
    lanes are the sensors' scans, each with its own seed, pair list and
    answer (``MapLoop`` over ``BatchLoop`` with a source per lane).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import graphs, tracing
from ..ops import se3
from ..ops.block_sparse import kd_block_order
from ..ops.correspondence import CorrespondenceParams, fit_planes
from ..ops.degeneracy import (DegeneracyAnalysis, DegeneracyThresholds,
                              DetectionMethod, HandlingMethod, analyze)
from ..ops.solvers import solve
from ..ops.voxel_grid import VoxelGrid, build_voxel_grid, voxel_knn
from ..utils import check_precise, resolve_device
from .icp import ICPParams
from .icp_batch import BatchLoop, estimate_map_capacities


class OdometryParams(NamedTuple):
    icp_iterations: int = 8          # fixed-trip masked GN iterations
    convergence_thresh_trans: float = 1e-3
    convergence_thresh_rot: float = 1e-4
    min_effective_points: int = 10
    corr: CorrespondenceParams = CorrespondenceParams()
    thresholds: DegeneracyThresholds = DegeneracyThresholds()
    capacity: int = 32               # candidates drawn per neighbour voxel
    chunk: int = 1024                # queries per voxel_knn chunk
    use_constant_velocity: bool = True
    use_weight_derivative: bool = True


class OdometryResult(NamedTuple):
    poses: torch.Tensor             # (F, 4, 4) world_T_body per frame
    iterations: torch.Tensor        # (F,) active ICP trips
    converged: torch.Tensor         # (F,) bool: stopped within the trips
    #                                 (converged, too few points, or a
    #                                 step that is not finite)
    rmse: torch.Tensor              # (F,)
    fitness: torch.Tensor           # (F,)
    effective_points: torch.Tensor  # (F,)
    is_degenerate: torch.Tensor     # (F,) bool
    degenerate_mask: torch.Tensor   # (F, 6) bool
    cond_schur_rot: torch.Tensor    # (F,)
    cond_schur_trans: torch.Tensor  # (F,)
    cond_full: torch.Tensor         # (F,)


def _seed(R_prev, t_prev, R_prev2, t_prev2, constant_velocity: bool):
    """A frame's initial pose: T_prev (T_prev2^-1 T_prev) under the
    constant-velocity model, else T_prev.  The composition squares
    rounding-level non-orthonormality, so the rotation is projected back
    onto SO(3).  Batched over a leading lane axis where the rotations are
    (S, 3, 3)."""
    if not constant_velocity:
        return R_prev, t_prev
    if R_prev.ndim == 3:
        dR = R_prev2.transpose(1, 2) @ R_prev
        dt = torch.einsum("sji,sj->si", R_prev2, t_prev - t_prev2)
        return se3.orthonormalize(R_prev @ dR), \
            torch.einsum("sij,sj->si", R_prev, dt) + t_prev
    dR = R_prev2.T @ R_prev
    dt = R_prev2.T @ (t_prev - t_prev2)
    return se3.orthonormalize(R_prev @ dR), R_prev @ dt + t_prev


def _map_system(scan, scan_valid, grid: VoxelGrid, R, t,
                params: OdometryParams):
    """The point-to-plane GN system of ``scan`` at pose (R, t) against the
    indexed map: (H, g, n_valid, rmse, fitness)."""
    cp = params.corr
    k = cp.k
    p_w = scan @ R.T + t
    sq_d, idx = voxel_knn(grid, p_w, k=k, capacity=params.capacity,
                          chunk=params.chunk)
    in_radius = sq_d[:, k - 1] < cp.search_radius ** 2
    neigh = grid.points[idx]
    normal, d_off, fit_ok = fit_planes(neigh)
    plane_dist = torch.einsum("nkj,nj->nk", neigh, normal) + d_off[:, None]
    plane_ok = torch.amax(plane_dist * plane_dist, dim=-1) \
        < cp.max_plane_thickness ** 2
    residual = torch.einsum("nj,nj->n", p_w, normal) + d_off
    s = torch.clamp(1.0 - cp.weight_slope * torch.abs(residual), min=0.0)
    valid = (in_radius & fit_ok & plane_ok & (s > cp.min_weight)
             & scan_valid)
    s = torch.where(valid, s, 0.0)
    if params.use_weight_derivative:
        # d(s r)/dr = s + r ds/dr on the ramp 0 < s < 1
        on_ramp = (s > 0.0) & (s < 1.0)
        ds_dr = torch.where(on_ramp, -cp.weight_slope * torch.sign(residual),
                            0.0)
        row_scale = torch.where(valid, s + residual * ds_dr, 0.0)
    else:
        row_scale = s
    nR = normal @ R
    Jw = torch.linalg.cross(scan, nR, dim=-1)
    J = torch.cat([Jw, nR], dim=-1) * row_scale[:, None]
    b = -(s * residual)
    H = J.T @ J
    g = J.T @ b
    n_valid = torch.sum(valid.to(torch.int32))
    raw_sq = torch.where(valid, residual * residual, 0.0)
    rmse = torch.sqrt(torch.sum(raw_sq) / torch.clamp(n_valid, min=1))
    n_src = torch.clamp(torch.sum(scan_valid.to(torch.int32)), min=1)
    fitness = torch.sum(in_radius.to(scan.dtype)) / n_src
    return H, g, n_valid, rmse, fitness


# the loops' output rows are preallocated in blocks of this many frames,
# so sequences of any length up to it share one capture
ROW_BLOCK = 128

class VoxelLoop:
    """``run_odometry``'s frame as the parts of its compiled scan over a
    ``graphs.State``: a masked DCReg ICP of at most
    ``params.icp_iterations`` trips against the indexed map.  The host
    copies each frame's scan and mask into the state (``scan``,
    ``scan_valid``) before its prologue.

      * ``prologue`` the constant-velocity seed from the previous two
        poses in the state, the first evaluation (``_map_system``) and
        its ``analyze``;
      * ``step`` one trip: the solve, the pose update, the convergence
        test and ``active`` (``done`` is its negation, read by the host
        once per trip), then the next evaluation at the new pose.  A
        trip after the frame stopped changes no pose and repeats the
        evaluation at the final pose, so the step that stops the frame
        takes that evaluation and the loop ends; after the last trip the
        loop keeps the evaluation before it (``trip`` is the device-side
        trip counter);
      * ``epilogue`` writes the frame's row at the device-side frame
        index ``f`` of preallocated ``(rows, ...)`` tensors and moves the
        motion model on.

    ``key()`` holds the statics and the address and layout of the
    grid."""

    def __init__(self, grid: VoxelGrid, N: int, detection, handling,
                 params: OdometryParams, rows: int, device, dtype):
        self.grid, self.N, self.rows = grid, N, rows
        self.detection, self.handling, self.params = detection, handling, \
            params
        self.dev, self.dtype = device, dtype

    def key(self) -> tuple:
        return ("run_odometry", self.N, self.rows, self.detection,
                self.handling, self.params, str(self.dtype), str(self.dev),
                graphs.tensor_key(self.grid))

    def load(self, S, frame0, frame0_valid, T0) -> None:
        S.put("scan", frame0)
        S.put("scan_valid", frame0_valid)
        S.put("R_prev", T0[:3, :3])
        S.put("t_prev", T0[:3, 3])
        S.put("R_prev2", T0[:3, :3])
        S.put("t_prev2", T0[:3, 3])
        S.put("f", torch.zeros((), dtype=torch.int64, device=self.dev))

    def evaluate(self, S) -> dict:
        """The GN system at the state's pose and its analysis, by state
        slot."""
        values = _map_system(S.scan, S.scan_valid, self.grid, S.R, S.t,
                             self.params)
        ana = analyze(values[0], self.detection, self.params.thresholds)
        out = dict(zip(("H", "g", "n_valid", "rmse", "fitness"), values))
        out.update((f"ana.{k}", v) for k, v in ana._asdict().items())
        return out

    def prologue(self, S) -> None:
        dev = self.dev
        R, t = _seed(S.R_prev, S.t_prev, S.R_prev2, S.t_prev2,
                     self.params.use_constant_velocity)
        S.put("R", R)
        S.put("t", t)
        for name, value in self.evaluate(S).items():
            S.put(name, value)
        S.put("trip", torch.zeros((), dtype=torch.int64, device=dev))
        S.put("active", torch.ones((), dtype=torch.bool, device=dev))
        S.put("done", torch.zeros((), dtype=torch.bool, device=dev))

    def step(self, S) -> None:
        params = self.params
        dx, _ = solve(S.H, S.g, self.handling,
                      S.get_tuple("ana", DegeneracyAnalysis),
                      params.thresholds, telemetry=False)
        ok = (S.n_valid >= params.min_effective_points) \
            & torch.all(torch.isfinite(dx))
        dx = torch.where(ok, dx, torch.zeros_like(dx))
        R, t = se3.boxplus(S.R, S.t, dx)
        conv = (torch.linalg.norm(dx[:3]) < params.convergence_thresh_rot) \
            & (torch.linalg.norm(dx[3:]) < params.convergence_thresh_trans)
        active = ok & ~conv
        S.put("R", R)
        S.put("t", t)
        S.put("active", active)
        S.put("done", ~active)
        keep = S.trip < params.icp_iterations - 1
        for name, value in self.evaluate(S).items():
            S.put(name, torch.where(keep, value, getattr(S, name)))
        S.put("trip", S.trip + 1)

    def epilogue(self, S) -> None:
        R, t = S.R, S.t
        row = (se3.se3_matrix(R, t), S.trip, ~S.active, S.rmse, S.fitness,
               S.n_valid, getattr(S, "ana.is_degenerate"),
               getattr(S, "ana.degenerate_mask"),
               getattr(S, "ana.cond_schur_rot"),
               getattr(S, "ana.cond_schur_trans"),
               getattr(S, "ana.cond_full"))
        for name, value in zip(OdometryResult._fields, row):
            S.put_row(f"out.{name}", S.f, value, self.rows)
        S.put("R_prev2", S.R_prev)
        S.put("t_prev2", S.t_prev)
        S.put("R_prev", R)
        S.put("t_prev", t)
        S.put("f", S.f + 1)


def _odometry_impl(frames, frames_valid, grid: VoxelGrid, T0, detection,
                   handling, params: OdometryParams,
                   graphed: bool) -> OdometryResult:
    F, N = frames.shape[:2]
    loop = VoxelLoop(grid, N, detection, handling, params,
                     ROW_BLOCK * -(-F // ROW_BLOCK), frames.device,
                     frames.dtype)
    run, S = graphs.bind(
        loop, lambda S: loop.load(S, frames[0], frames_valid[0], T0),
        graphed, "run_odometry", frames.device)
    for f in range(F):
        if f:
            S.put("scan", frames[f])
            S.put("scan_valid", frames_valid[f])
        graphs.drive(run, S, params.icp_iterations)
    return OdometryResult(*(getattr(S, f"out.{name}")[:F].clone()
                            for name in OdometryResult._fields))


def run_odometry(frames, map_xyz, T0=None,
                 detection="SCHUR_CONDITION_NUMBER",
                 handling="PRECONDITIONED_CG",
                 params: OdometryParams = OdometryParams(),
                 frames_valid=None, map_valid=None, voxel_size=None,
                 device=None, graph=None) -> OdometryResult:
    """Register a stream of body-frame scans (F, N, 3) against a prior
    map, frame by frame, seeded by the constant-velocity model from T0.

    ``map_xyz`` is the map (M, 3), indexed here at ``voxel_size``
    (default the search radius), or a ``VoxelGrid`` already built over
    it (read in place: a call with the same grid replays).
    detection / handling take the enums or their names.  Runs in the
    frames' dtype on ``device`` (cuda unless told otherwise) and returns
    stacked per-frame telemetry: on the card each frame replays the CUDA
    graphs of its parts (``VoxelLoop``), captured at the first call of
    their statics; ``graph=False`` runs them eagerly, for checking only;
    on the CPU they run eagerly and ``graph=True`` raises."""
    check_precise()
    dev = resolve_device(device)
    graphed = graphs.use_graphs(dev, graph)
    if isinstance(detection, str):
        detection = DetectionMethod[detection]
    if isinstance(handling, str):
        handling = HandlingMethod[handling]
    frames = torch.as_tensor(frames, device=dev)
    dtype = frames.dtype
    T0 = torch.eye(4, dtype=dtype, device=dev) if T0 is None \
        else torch.as_tensor(T0, dtype=dtype, device=dev)
    frames_valid = (torch.ones(frames.shape[:2], dtype=torch.bool,
                               device=dev) if frames_valid is None
                    else torch.as_tensor(frames_valid, device=dev).bool())
    if isinstance(map_xyz, VoxelGrid):
        grid = map_xyz
    else:
        if voxel_size is None:
            voxel_size = params.corr.search_radius
        grid = build_voxel_grid(torch.as_tensor(map_xyz, dtype=dtype,
                                                device=dev),
                                voxel_size, valid=map_valid, device=dev)
    return _odometry_impl(frames, frames_valid, grid, T0, detection,
                          handling, params, graphed)


class MapOdometryResult(NamedTuple):
    poses: torch.Tensor             # (F, 4, 4) world_T_body per frame
    iterations: torch.Tensor        # (F,) int32
    converged: torch.Tensor         # (F,) bool
    aborted: torch.Tensor           # (F,) bool
    pair_overflow: torch.Tensor     # (F,) cull overflow + reuse breaches
    is_degenerate: torch.Tensor     # (F,) bool, from the final H
    degenerate_mask: torch.Tensor   # (F, 6) bool
    cond_schur_rot: torch.Tensor    # (F,)
    cond_schur_trans: torch.Tensor  # (F,)
    cond_full: torch.Tensor         # (F,)
    rmse: torch.Tensor              # (F,)
    fitness: torch.Tensor           # (F,)
    effective_points: torch.Tensor  # (F,) int32


class MapLoop:
    """``run_odometry_map``'s frame as the parts of its compiled scan over
    a ``graphs.State``: the ``prologue`` is the constant-velocity seed
    from the previous two poses in the state and the registration's
    prologue (``BatchLoop``, B = 1, reused pair list); the ``step`` is
    the registration's; the ``epilogue`` finishes the registration, runs
    the frame's analysis of ``H_last`` and writes the frame's output row
    at the device-side frame index ``f`` of preallocated ``(rows, ...)``
    tensors.  The host copies each frame's scan into the state's source
    (``src``) before its prologue.

    Over a ``BatchLoop`` with a source per lane (``run_odometry_fleet``)
    the same parts run one tick of S sensors: each lane's seed from its
    own two previous poses, the lanes' registrations in one, and the
    frame's analysis and output of every lane, written whole (``out.*``
    with a leading (S,) axis; no rows, no frame index).  A ragged
    ``BatchLoop`` takes each lane's point count into the state with its
    scan (``count``), as data: a tick with other counts replays."""

    def __init__(self, loop: BatchLoop, use_constant_velocity: bool,
                 frame_analysis_fast: bool, rows: int):
        self.loop, self.rows = loop, rows
        self.fleet = loop.per_lane
        self.cv = use_constant_velocity
        self.fast = (frame_analysis_fast and loop.detection
                     is DetectionMethod.SCHUR_CONDITION_NUMBER)

    def key(self) -> tuple:
        return ("run_odometry_map", self.loop.key(), self.cv, self.fast,
                self.rows)

    def load(self, S, frame0, T0, T_prev, count=None) -> None:
        S.put("src", frame0)
        if count is not None:
            S.put("count", count)
        S.put("R_prev", T0[..., :3, :3])
        S.put("t_prev", T0[..., :3, 3])
        S.put("R_prev2", T_prev[..., :3, :3])
        S.put("t_prev2", T_prev[..., :3, 3])
        S.put("T_gt", torch.eye(4, dtype=T0.dtype, device=T0.device))
        if not self.fleet:
            S.put("f", torch.zeros((), dtype=torch.int64, device=T0.device))

    def prologue(self, S) -> None:
        R_pred, t_pred = _seed(S.R_prev, S.t_prev, S.R_prev2, S.t_prev2,
                               self.cv)
        S.put("R0", R_pred if self.fleet else R_pred[None])
        S.put("t0", t_pred if self.fleet else t_pred[None])
        self.loop.prologue(S)

    def step(self, S) -> None:
        self.loop.step(S)

    def epilogue(self, S) -> None:
        self.loop.finish(S)
        lane = slice(None) if self.fleet else 0
        R, t = S.Rs[lane], S.ts[lane]
        ana = analyze(S.H_last[lane], self.loop.detection,
                      self.loop.params.thresholds, fast=self.fast)
        row = (se3.se3_matrix(R, t), S.iters[lane], S.conv[lane],
               S.abt[lane], S.ovf.to(torch.int32), ana.is_degenerate,
               ana.degenerate_mask, ana.cond_schur_rot,
               ana.cond_schur_trans, ana.cond_full, S.rmse[lane],
               S.fitness[lane], S.num_valid[lane])
        if self.fleet:
            for name, value in zip(MapOdometryResult._fields, row):
                S.put(f"out.{name}", value)
            return
        for name, value in zip(MapOdometryResult._fields, row):
            S.put_row(f"out.{name}", S.f, value, self.rows)
        S.put("R_prev2", S.R_prev)
        S.put("t_prev2", S.t_prev)
        S.put("R_prev", R)
        S.put("t_prev", t)
        S.put("f", S.f + 1)


def _odometry_map_impl(frames, map_xyz, mindex, T0, T_prev, detection,
                       handling, params, num_pairs, num_supers,
                       max_per_query, initial_cull_radius, reuse_margin,
                       use_constant_velocity, frame_analysis_fast,
                       device, graphed) -> MapOdometryResult:
    F, N = frames.shape[:2]
    loop = BatchLoop(mindex, map_xyz, 1, N, detection, handling, params,
                     num_pairs, num_supers, max_per_query,
                     initial_cull_radius, reuse_margin, device)
    mloop = MapLoop(loop, use_constant_velocity, frame_analysis_fast,
                    ROW_BLOCK * -(-F // ROW_BLOCK))

    run, S = graphs.bind(mloop, lambda S: mloop.load(S, frames[0], T0,
                                                     T_prev),
                         graphed, "run_odometry_map", device)
    for f in range(F):
        if f:
            S.put("src", frames[f])
        graphs.drive(run, S, params.max_iterations)
    with tracing.span("odometry.results"):
        return MapOdometryResult(*(getattr(S, f"out.{name}")[:F].clone()
                                   for name in MapOdometryResult._fields))


def _frame_capacities(mindex, frame, T, Tp, Tp2, radius, **kw):
    """``estimate_map_capacities`` of one frame at its hinted pose T, the
    previous pose Tp and the constant-velocity prediction from Tp2, Tp."""
    T, Tp, Tp2 = (np.asarray(x, np.float64) for x in (T, Tp, Tp2))
    Tpred = Tp @ np.linalg.inv(Tp2) @ Tp
    return estimate_map_capacities(
        mindex, frame, [(T[:3, :3], T[:3, 3]), (Tp[:3, :3], Tp[:3, 3]),
                        (Tpred[:3, :3], Tpred[:3, 3])], radius,
        include_identity=False, **kw)


def estimate_odometry_capacities(mindex, frames, traj_hint, radius,
                                 margin: float = 1.3, sup_margin: int = 2,
                                 stride: int = 1, slot_margin: float = None):
    """Static (num_supers, max_per_query, num_pairs) covering every frame:
    the max of per-frame ``estimate_map_capacities`` at the hinted pose,
    the previous one and the constant-velocity prediction.  A fleet's
    lanes each take these capacities (``run_odometry_fleet``), so capacities
    estimated over every frame any sensor scans cover every lane."""
    S = G = P = 0
    for f in range(0, len(frames), max(1, stride)):
        s, g, p = _frame_capacities(
            mindex, frames[f], traj_hint[f], traj_hint[max(f - 1, 0)],
            traj_hint[max(f - 2, 0)], radius, margin=margin,
            sup_margin=sup_margin, slot_margin=slot_margin)
        S, G, P = max(S, s), max(G, g), max(P, p)
    return S, G, P


def _map_method(detection, handling, icp_params):
    """The map loops' detection and handling (the enums, their names, or
    None for DCReg's Schur test and PCG) and ICP parameters (None for the
    defaults), telemetry off."""
    if detection is None:
        detection = DetectionMethod.SCHUR_CONDITION_NUMBER
    if handling is None:
        handling = HandlingMethod.PRECONDITIONED_CG
    if isinstance(detection, str):
        detection = DetectionMethod[detection]
    if isinstance(handling, str):
        handling = HandlingMethod[handling]
    if icp_params is None:
        icp_params = ICPParams()
    return detection, handling, icp_params._replace(full_telemetry=False)


@tracing.calls("odometry.call")
def run_odometry_map(frames, mindex, map_xyz, T0=None, detection=None,
                     handling=None, icp_params=None, num_supers: int = 0,
                     max_per_query: int = 0, num_pairs: int = 0,
                     initial_cull_radius: float = 0.3,
                     reuse_margin: float = 0.2,
                     use_constant_velocity: bool = True, traj_hint=None,
                     T_prev_init=None, frame_analysis_fast: bool = True,
                     device=None, graph=None) -> MapOdometryResult:
    """The localization loop of one sensor against a map-scale prior: per
    frame, a constant-velocity seed + one B = 1 map-mode DCReg
    registration with a reused pair list.  A fleet of sensors, one scan
    each per tick, registers in one call of ``run_odometry_fleet``.

    frames (F, N, 3) body-frame scans, each kd-block-sorted
    (``prepare_frames``); map_xyz (M, 3) the sorted map ``mindex`` was
    built over.  Capacities must cover every frame at radius
    initial_cull_radius + reuse_margin: pass them, or pass ``traj_hint``
    (F, 4, 4) to estimate them here.  ``T_prev_init`` is the pose one
    frame before T0 (known initial velocity).  Runs on ``device`` (cuda
    unless told otherwise): on the card each frame replays the CUDA
    graphs of its parts (``MapLoop``), captured at the first call of
    their statics; ``graph=False`` runs them eagerly, for checking only;
    on the CPU they run eagerly and ``graph=True`` raises.  Each call is
    an ``odometry.call`` span (``tracing.calls``)."""
    check_precise()
    dev = resolve_device(device)
    graphed = graphs.use_graphs(dev, graph)
    detection, handling, icp_params = _map_method(detection, handling,
                                                  icp_params)
    f32 = lambda x: torch.as_tensor(x, dtype=torch.float32, device=dev)
    frames = f32(frames)
    map_xyz = f32(map_xyz)
    T0 = torch.eye(4, dtype=torch.float32, device=dev) if T0 is None \
        else f32(T0)
    T_prev_init = T0 if T_prev_init is None else f32(T_prev_init)
    if num_supers <= 0 or max_per_query <= 0 or num_pairs <= 0:
        if traj_hint is None:
            raise ValueError("pass capacities or traj_hint for host-side "
                             "estimation")
        num_supers, max_per_query, num_pairs = estimate_odometry_capacities(
            mindex, frames.cpu().numpy(), traj_hint,
            initial_cull_radius + reuse_margin)
    return _odometry_map_impl(frames, map_xyz, mindex, T0, T_prev_init,
                              detection, handling, icp_params,
                              int(num_pairs), int(num_supers),
                              int(max_per_query), float(initial_cull_radius),
                              float(reuse_margin),
                              bool(use_constant_velocity),
                              bool(frame_analysis_fast), dev, graphed)


def _odometry_fleet_impl(scans, map_xyz, mindex, T0, T_prev, detection,
                         handling, params, num_pairs, num_supers,
                         max_per_query, initial_cull_radius, reuse_margin,
                         use_constant_velocity, frame_analysis_fast,
                         counts, device, graphed) -> MapOdometryResult:
    L, N = scans.shape[:2]
    loop = BatchLoop(mindex, map_xyz, L, N, detection, handling, params,
                     num_pairs, num_supers, max_per_query,
                     initial_cull_radius, reuse_margin, device,
                     per_lane=True, ragged=counts is not None)
    mloop = MapLoop(loop, use_constant_velocity, frame_analysis_fast, 1)
    run, S = graphs.bind(mloop, lambda S: mloop.load(S, scans, T0, T_prev,
                                                     counts),
                         graphed, "run_odometry_fleet", device)
    graphs.drive_lanes(run, S, params.max_iterations)
    with tracing.span("odometry.results"):
        return MapOdometryResult(*(getattr(S, f"out.{name}").clone()
                                   for name in MapOdometryResult._fields))


def _fleet_capacity(scans, *_, **__) -> int:
    """A tick's rows, S x N, from the shape of ``scans``."""
    shape = np.shape(scans)
    return int(shape[0] * shape[1])


def _fleet_points(scans, *_, counts=None, **__) -> int:
    """A tick's points, from the host: the sum of ``counts``, else
    every row."""
    if counts is None:
        return _fleet_capacity(scans)
    return int(np.sum(np.asarray(counts)))


@tracing.calls("odometry.fleet_call",
               sensors=lambda scans, *_, **__: len(scans),
               points=_fleet_points, capacity=_fleet_capacity)
def run_odometry_fleet(scans, mindex, map_xyz, T0, T_prev_init,
                       detection=None, handling=None, icp_params=None,
                       num_supers: int = 0, max_per_query: int = 0,
                       num_pairs: int = 0, initial_cull_radius: float = 0.3,
                       reuse_margin: float = 0.2,
                       use_constant_velocity: bool = True,
                       frame_analysis_fast: bool = True, counts=None,
                       device=None, graph=None) -> MapOdometryResult:
    """One tick of a fleet of S sensors localizing against one map-scale
    prior: per sensor, the constant-velocity seed from its own two last
    poses and a map-mode DCReg registration with a reused pair list, all
    S in one batched registration (``MapLoop`` over a ``BatchLoop`` with
    a source per lane, K1 in its per-lane mode).

    Each lane is ``run_odometry_map``'s frame, alone: its own pair list,
    culled at its seed with radius initial_cull_radius + reuse_margin in
    a capacity of its own (``num_pairs`` pairs per lane), its own live
    mask, Schur test, PCG and frame analysis.  A lane that converges
    stops moving; one that aborts or overflows changes no other lane's
    answer; the step runs until every lane is done, on the card a tick in
    one launch with the test between steps on the card
    (``graphs.drive_lanes``, ``ops/loop_cond``).

    scans (S, N, 3) body-frame scans, each kd-block-sorted
    (``prepare_frames``); map_xyz (M, 3) the sorted map ``mindex`` was
    built over; T0 (S, 4, 4) each sensor's last pose, T_prev_init
    (S, 4, 4) the one before it.  ``counts`` (S,) ints on the host, each
    in 1..N, where the scans differ in size: N is then the fleet's
    capacity, lane s's first ``counts[s]`` rows are its scan,
    kd-block-sorted, and the rows after them are pads whose values do not
    matter (each lane answers as its scan alone would; its ``fitness`` is
    over its count).  The counts are data: a tick with other counts
    replays the same graphs.  The capacities are per lane and must cover
    every lane (``estimate_odometry_capacities`` over the scans the
    sensors send).  Returns a ``MapOdometryResult`` whose fields lead
    with (S,), one row per sensor.  Runs as ``run_odometry_map`` does: on
    the card the parts replay CUDA graphs keyed on S, N, whether counts
    are given, and the statics; ``graph=False`` runs them eagerly, for
    checking only; on the CPU they run eagerly.  Each call is an
    ``odometry.fleet_call`` span with the sensor count, the tick's points
    (the sum of the counts) and its capacity (S x N)."""
    check_precise()
    dev = resolve_device(device)
    graphed = graphs.use_graphs(dev, graph)
    detection, handling, icp_params = _map_method(detection, handling,
                                                  icp_params)
    if num_supers <= 0 or max_per_query <= 0 or num_pairs <= 0:
        raise ValueError("pass the per-lane capacities "
                         "(estimate_odometry_capacities)")
    if reuse_margin <= 0:
        raise ValueError("a fleet tick reuses each lane's pair list: "
                         "reuse_margin must be positive")
    f32 = lambda x: torch.as_tensor(x, dtype=torch.float32, device=dev)
    scans, map_xyz = f32(scans), f32(map_xyz)
    T0, T_prev_init = f32(T0), f32(T_prev_init)
    L = scans.shape[0]
    if scans.ndim != 3 or T0.shape != (L, 4, 4) \
            or T_prev_init.shape != (L, 4, 4):
        raise ValueError(f"scans (S, N, 3) with T0 and T_prev_init "
                         f"(S, 4, 4); got {tuple(scans.shape)}, "
                         f"{tuple(T0.shape)}, {tuple(T_prev_init.shape)}")
    if counts is not None:
        host = np.asarray(counts)
        if host.shape != (L,) or host.dtype.kind not in "iu" \
                or host.min() < 1 or host.max() > scans.shape[1]:
            raise ValueError(f"counts: ({L},) ints in 1..{scans.shape[1]}, "
                             f"got {host!r}")
        counts = torch.as_tensor(host, dtype=torch.int64, device=dev)
    return _odometry_fleet_impl(scans, map_xyz, mindex, T0, T_prev_init,
                                detection, handling, icp_params,
                                int(num_pairs), int(num_supers),
                                int(max_per_query),
                                float(initial_cull_radius),
                                float(reuse_margin),
                                bool(use_constant_velocity),
                                bool(frame_analysis_fast), counts, dev,
                                graphed)


def prepare_frames(frames, block: int = 128) -> np.ndarray:
    """kd-block-sort each body-frame scan (host, once per sequence)."""
    out = np.asarray(frames, np.float32).copy()
    for f in range(out.shape[0]):
        out[f] = out[f][kd_block_order(out[f], block)]
    return out
