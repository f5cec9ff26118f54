"""Gauss-Newton system assembly (counterpart of
``dcreg_tpu/ops/gauss_newton.py``).

Rows J_r = [-n^T R [p]x, n^T R] (right perturbation) are built batched
and reduced to the 6x6 system by one (6, N) @ (N, 6) product; invalid
rows carry zero weight.  Two row scalings, as the reference has:
``use_weight_derivative=True`` scales J_r by s + r ds/dr with
ds/dr = -slope sign(r) on the active ramp 0 < s < 1 (the mode of the
archived benchmark runs); ``False`` scales it by s.  In both b = -s r.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class GNSystem(NamedTuple):
    H: torch.Tensor          # (..., 6, 6) J^T J
    g: torch.Tensor          # (..., 6)  J^T b with b = -s r (H dx = g)
    num_valid: torch.Tensor  # (...,) int: effective correspondences
    rmse: torch.Tensor       # (...,) sqrt(mean raw residual^2 over valid)
    fitness: torch.Tensor    # (...,) fraction of points with 5-NN in radius
    objective: torch.Tensor  # (...,) 0.5 * ||s r||^2


def build_system(source_xyz, R, t, corr, num_source=None,
                 use_weight_derivative: bool = True,
                 weight_slope: float = 0.9) -> GNSystem:
    """Assemble the 6x6 GN system from a correspondence set.

    source_xyz (N, 3) body-frame points; (R, t) the pose J is linearised
    at; corr from ``find_correspondences``; num_source the true source
    count for the fitness denominator (N when None)."""
    dtype = source_xyz.dtype
    s = torch.where(corr.valid, corr.weight, 0.0).to(dtype)
    if use_weight_derivative:
        on_ramp = (s > 0.0) & (s < 1.0)
        ds_dr = torch.where(on_ramp, -weight_slope
                            * torch.sign(corr.residual), 0.0)
        row_scale = s + corr.residual * ds_dr
    else:
        row_scale = s
    row_scale = torch.where(corr.valid, row_scale, 0.0)
    nR = corr.normal @ R                                   # rows n^T R
    Jw = torch.linalg.cross(source_xyz, nR, dim=-1)        # p x (n^T R)
    J = torch.cat([Jw, nR], dim=-1) * row_scale[:, None]   # (N, 6)
    b = -(s * corr.residual)
    H = J.T @ J
    g = J.T @ b
    n_valid = torch.sum(corr.valid.to(torch.int32))
    raw_sq = torch.where(corr.valid, corr.residual * corr.residual, 0.0)
    rmse = torch.sqrt(torch.sum(raw_sq)
                      / torch.clamp(n_valid, min=1).to(dtype))
    denom = float(num_source if num_source is not None
                  else source_xyz.shape[0])
    fitness = torch.sum(corr.in_radius.to(dtype)) / denom
    objective = 0.5 * torch.sum(b * b)
    return GNSystem(H=H, g=g, num_valid=n_valid, rmse=rmse,
                    fitness=fitness, objective=objective)
