"""Target-cloud normal estimation (counterpart of
``dcreg_tpu/ops/normals.py``): per point, the k nearest neighbours, their
covariance, and its smallest eigenvector as the normal, flipped toward
the viewpoint (the origin by default).  One k-NN sweep and one batched
3x3 eigensolve.

The single-pass float32 covariance is computed as the JAX module
computes it on the CPU, where XLA reduces sequentially and fuses
multiply-adds: the sum of outer products accumulates one fused
multiply-add per term, and the scaling by 1/k fuses with the
subtraction of mu mu^T.  A fused step here takes the exact product and
the addend in float64 and rounds their sum once to float32.  So the
covariance, noise included, is the JAX module's bit for bit there.
"""
from __future__ import annotations

import numpy as np
import torch

from . import knn as knn_mod
from . import linalg


def _seq_sum(x):
    """Sum over dim 1, one term after the other."""
    s = x[:, 0]
    for j in range(1, x.shape[1]):
        s = s + x[:, j]
    return s


def _seq_gram(x):
    """sum_k x_k x_k^T of x (N, K, 3), one term after the other, each
    step a fused multiply-add in x's dtype (float32 through float64)."""
    wide = torch.float64 if x.dtype == torch.float32 else x.dtype
    s = torch.zeros(x.shape[0], 3, 3, dtype=x.dtype, device=x.device)
    for j in range(x.shape[1]):
        a = x[:, j].to(wide)
        s = (a[:, :, None] * a[:, None, :] + s.to(wide)).to(x.dtype)
    return s


def estimate_normals(points, k: int = 5, valid=None, viewpoint=None,
                     chunk: int = 2048, pcl_compat: bool = True):
    """(N, 3) unit normals of ``points`` oriented toward ``viewpoint``.

    ``pcl_compat=True`` (default) reproduces PCL's single-pass float32
    covariance E[x x^T] - mu mu^T, whose cancellation at LiDAR coordinate
    scale perturbs the normals by about 1e-3 rad; the XICP, SuperLoc and
    O3D baselines need that noise to follow the reference's trajectories.
    ``pcl_compat=False`` takes the centred two-pass covariance in the
    points' dtype.  The neighbours come from ``knn.knn`` (K2 in float32,
    ``refine`` 2k)."""
    _, idx = knn_mod.knn(points, points, valid, k=k, chunk=chunk,
                         refine=2 * k)
    neigh = points[idx]                                  # (N, k, 3)
    if pcl_compat:
        n32 = neigh.to(torch.float32)
        mu = _seq_sum(n32) * (1.0 / k)
        mm = (mu[:, :, None] * mu[:, None, :]).double()
        inv_k = float(np.float32(1.0 / k))
        cov = (_seq_gram(n32).double() * inv_k - mm).to(torch.float32)
        cov = cov.to(points.dtype)
    else:
        centered = neigh - (_seq_sum(neigh) / k)[:, None, :]
        cov = _seq_gram(centered) / k
    _, V = linalg.symmetric_eigh(cov)
    normal = V[..., 0]                                   # smallest eigvec
    if viewpoint is None:
        viewpoint = torch.zeros(3, dtype=points.dtype, device=points.device)
    to_vp = viewpoint[None, :] - points
    flip = torch.sum(normal * to_vp, dim=-1) < 0.0
    return torch.where(flip[:, None], -normal, normal)
