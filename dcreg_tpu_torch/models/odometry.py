"""Scan-to-map localization loop (counterpart of the map-scale half of
``dcreg_tpu/models/odometry.py``; the voxel-grid ``run_odometry`` is not
ported yet).

Per frame: a constant-velocity motion-model seed (projected back onto
SO(3) every frame) and one B = 1 map-mode DCReg registration with a
single reused pair list.  The JAX ``lax.scan`` over frames is a Python
loop here.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..ops import se3
from ..ops.block_sparse import kd_block_order
from ..ops.degeneracy import DetectionMethod, HandlingMethod, analyze
from ..utils import check_precise, resolve_device
from .icp import ICPParams
from .icp_batch import estimate_map_capacities, icp_batch_so3


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


def _odometry_map_impl(frames, map_xyz, mindex, T0, T_prev, detection,
                       handling, params, num_pairs, num_supers,
                       max_per_query, initial_cull_radius, reuse_margin,
                       use_constant_velocity, frame_analysis_fast,
                       device) -> MapOdometryResult:
    R_prev, t_prev = T0[:3, :3], T0[:3, 3]
    R_prev2, t_prev2 = T_prev[:3, :3], T_prev[:3, 3]
    fast_ok = (frame_analysis_fast
               and detection is DetectionMethod.SCHUR_CONDITION_NUMBER)
    outs = []
    for f in range(frames.shape[0]):
        if use_constant_velocity:
            # T_pred = T_prev (T_prev2^-1 T_prev); the composition squares
            # rounding-level non-orthonormality, so project onto SO(3)
            dR = R_prev2.T @ R_prev
            dt = R_prev2.T @ (t_prev - t_prev2)
            R_pred = se3.orthonormalize(R_prev @ dR)
            t_pred = R_prev @ dt + t_prev
        else:
            R_pred, t_pred = R_prev, t_prev
        out = icp_batch_so3(frames[f], map_xyz, R_pred[None], t_pred[None],
                            detection, handling, params, mindex, num_pairs,
                            num_supers=num_supers,
                            max_per_query=max_per_query,
                            initial_cull_radius=initial_cull_radius,
                            reuse_pair_list=reuse_margin, device=device)
        R, t = out.R[0], out.t[0]
        ana = analyze(out.H_last[0], detection, params.thresholds,
                      fast=fast_ok)
        outs.append((se3.se3_matrix(R, t), out.iterations[0],
                     out.converged[0], out.aborted[0],
                     out.pair_overflow.to(torch.int32), ana.is_degenerate,
                     ana.degenerate_mask, ana.cond_schur_rot,
                     ana.cond_schur_trans, ana.cond_full, out.rmse[0],
                     out.fitness[0], out.num_valid[0]))
        R_prev2, t_prev2, R_prev, t_prev = R_prev, t_prev, R, t
    cols = [torch.stack(c) for c in zip(*outs)]
    return MapOdometryResult(*cols)


def estimate_odometry_capacities(mindex, frames, traj_hint, radius,
                                 margin: float = 1.3, sup_margin: int = 2,
                                 stride: int = 1, slot_margin: float = None):
    """Static (num_supers, max_per_query, num_pairs) covering every frame:
    the max of per-frame ``estimate_map_capacities`` at the hinted pose,
    the previous one and the constant-velocity prediction."""
    S = G = P = 0
    for f in range(0, len(frames), max(1, stride)):
        T = np.asarray(traj_hint[f], np.float64)
        Tp = np.asarray(traj_hint[max(f - 1, 0)], np.float64)
        Tp2 = np.asarray(traj_hint[max(f - 2, 0)], np.float64)
        Tpred = Tp @ np.linalg.inv(Tp2) @ Tp
        s, g, p = estimate_map_capacities(
            mindex, frames[f],
            [(T[:3, :3], T[:3, 3]), (Tp[:3, :3], Tp[:3, 3]),
             (Tpred[:3, :3], Tpred[:3, 3])], radius,
            margin=margin, sup_margin=sup_margin, include_identity=False,
            slot_margin=slot_margin)
        S, G, P = max(S, s), max(G, g), max(P, p)
    return S, G, P


def run_odometry_map(frames, mindex, map_xyz, T0=None, detection=None,
                     handling=None, icp_params=None, num_supers: int = 0,
                     max_per_query: int = 0, num_pairs: int = 0,
                     initial_cull_radius: float = 0.3,
                     reuse_margin: float = 0.2,
                     use_constant_velocity: bool = True, traj_hint=None,
                     T_prev_init=None, frame_analysis_fast: bool = True,
                     device=None) -> MapOdometryResult:
    """The localization loop against a map-scale prior: per frame, a
    constant-velocity seed + one B = 1 map-mode DCReg registration with a
    reused pair list.

    frames (F, N, 3) body-frame scans, each kd-block-sorted
    (``prepare_frames``); map_xyz (M, 3) the sorted map ``mindex`` was
    built over.  Capacities must cover every frame at radius
    initial_cull_radius + reuse_margin: pass them, or pass ``traj_hint``
    (F, 4, 4) to estimate them here.  ``T_prev_init`` is the pose one
    frame before T0 (known initial velocity).  Runs on ``device`` (cuda
    unless told otherwise)."""
    check_precise()
    dev = resolve_device(device)
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
    icp_params = icp_params._replace(full_telemetry=False)
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
                              bool(frame_analysis_fast), dev)


def prepare_frames(frames, block: int = 128) -> np.ndarray:
    """kd-block-sort each body-frame scan (host, once per sequence)."""
    out = np.asarray(frames, np.float32).copy()
    for f in range(out.shape[0]):
        out[f] = out[f][kd_block_order(out[f], block)]
    return out
