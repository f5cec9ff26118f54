"""Registration quality metrics: point-to-point RMSE, fitness and Chamfer
distance (counterpart of ``dcreg_tpu/ops/metrics.py``).

Forward 1-NN from the aligned cloud to the target gives the RMSE over
inliers (distance < error_threshold) normalised by the FULL aligned count,
as the reference does, and the inlier fraction; the symmetric Chamfer
distance averages the forward and backward mean 1-NN distances.  Both
searches go through ``knn.nn1`` (K2 in f32).
"""
from __future__ import annotations

import torch

from . import knn as knn_mod


def point_to_point_error(aligned_xyz, target_xyz, error_threshold,
                         aligned_valid=None, target_valid=None,
                         chunk: int = 2048):
    """Returns (rmse, fitness, chamfer, valid_correspondences)."""
    dtype = aligned_xyz.dtype
    fwd_sq, _ = knn_mod.nn1(aligned_xyz, target_xyz, target_valid,
                            chunk=chunk)
    fwd = torch.sqrt(fwd_sq)
    n_aligned = (torch.sum(aligned_valid.to(dtype))
                 if aligned_valid is not None
                 else torch.tensor(float(aligned_xyz.shape[0]), dtype=dtype,
                                   device=aligned_xyz.device))
    if aligned_valid is not None:
        fwd = torch.where(aligned_valid, fwd, 0.0)
        fwd_sq = torch.where(aligned_valid, fwd_sq, 0.0)
    inlier = fwd < error_threshold
    if aligned_valid is not None:
        inlier = inlier & aligned_valid
    valid_corr = torch.sum(inlier.to(torch.int32))
    rmse = torch.sqrt(torch.sum(torch.where(inlier, fwd_sq, 0.0))
                      / n_aligned)
    fitness = valid_corr.to(dtype) / n_aligned
    bwd_sq, _ = knn_mod.nn1(target_xyz, aligned_xyz, aligned_valid,
                            chunk=chunk)
    bwd = torch.sqrt(bwd_sq)
    n_target = (torch.sum(target_valid.to(dtype))
                if target_valid is not None
                else float(target_xyz.shape[0]))
    if target_valid is not None:
        bwd = torch.where(target_valid, bwd, 0.0)
    chamfer = 0.5 * (torch.sum(fwd) / n_aligned + torch.sum(bwd) / n_target)
    return rmse, fitness, chamfer, valid_corr
