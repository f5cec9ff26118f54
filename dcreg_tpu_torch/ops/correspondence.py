"""Correspondence pipeline: transform -> 5-NN -> plane fit -> robust
weight (counterpart of ``dcreg_tpu/ops/correspondence.py``).

Per transformed source point the pass requires all k neighbours within
``search_radius``, fits the plane n.p + d = 0 through them (the least
squares of A x = -1), rejects a neighbour set thicker than
``max_plane_thickness`` and weights the residual r = n.p + d with
s = max(0, 1 - slope |r|), keeping the point while s > min_weight.  Shapes
stay fixed: a validity mask takes the place of compaction.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from . import knn as knn_mod
from . import linalg


class Correspondences(NamedTuple):
    """Fixed-shape correspondence set (mask instead of compaction)."""
    valid: torch.Tensor       # (N,) bool: contributes to the GN system
    in_radius: torch.Tensor   # (N,) bool: all k NN within search radius
    normal: torch.Tensor      # (N, 3) unit plane normal
    residual: torch.Tensor    # (N,) raw signed point-to-plane distance
    weight: torch.Tensor      # (N,) robust weight s (0 where invalid)
    nn_idx: torch.Tensor      # (N, K) neighbour indices


class CorrespondenceParams(NamedTuple):
    search_radius: float = 1.0
    max_plane_thickness: float = 0.2
    weight_slope: float = 0.9
    min_weight: float = 0.1
    k: int = 5
    num_blocks: int = 16


def householder_lstsq(A, b):
    """Least-squares solve of A x = b for A (..., m, n), m >= n, by n
    Householder reflections and back substitution; batched, branchless."""
    n = A.shape[-1]
    R = A
    y = b[..., None] if b.ndim == A.ndim - 1 else b
    for j in range(n):
        x = R[..., j:, j]
        normx = torch.sqrt(torch.sum(x * x, dim=-1))
        lead = torch.where(x[..., 0] == 0, torch.ones_like(x[..., 0]),
                           x[..., 0])
        alpha = -torch.sign(lead) * normx
        v = torch.cat([(x[..., 0] - alpha)[..., None], x[..., 1:]], dim=-1)
        vnorm2 = torch.sum(v * v, dim=-1)
        safe = vnorm2 > 0
        inv = torch.where(safe, 2.0 / torch.where(safe, vnorm2,
                                                  torch.ones_like(vnorm2)),
                          0.0)
        Rt = R[..., j:, :]
        coef = torch.einsum('...i,...ij->...j', v, Rt) * inv[..., None]
        R = torch.cat([R[..., :j, :],
                       Rt - v[..., :, None] * coef[..., None, :]], dim=-2)
        yt = y[..., j:, :]
        coef_y = torch.einsum('...i,...ij->...j', v, yt) * inv[..., None]
        y = torch.cat([y[..., :j, :],
                       yt - v[..., :, None] * coef_y[..., None, :]], dim=-2)
    xs = [None] * n
    for i in range(n - 1, -1, -1):
        rhs = y[..., i, 0]
        if i + 1 < n:
            rhs = rhs - sum(R[..., i, j] * xs[j] for j in range(i + 1, n))
        diag = R[..., i, i]
        safe = torch.abs(diag) > 1e-30
        xs[i] = torch.where(safe, rhs / torch.where(safe, diag,
                                                    torch.ones_like(diag)),
                            0.0)
    return torch.stack(xs, dim=-1)


def fit_planes(neighbor_xyz):
    """Planes n.p + d = 0 through K-neighbour sets (N, K, 3).  Returns
    (normal (N, 3) unit, d (N,), ok (N,) bool for |x| >= 1e-6).

    The least squares of A x = -1 in closed form through the centred
    normal equations (K + k c c^T) x = -k c, expanded in the eigenbasis of
    the centred scatter K with every 1/lambda ratio rescaled by the
    smallest active eigenvalue, so coplanar sets evaluate stably.  A
    direction with no data support (||A v||^2 below 100 eps of the
    largest) is dropped from the solve, as a rank-revealing QR would."""
    dtype = neighbor_xyz.dtype
    K = neighbor_xyz.shape[-2]
    c = torch.mean(neighbor_xyz, dim=-2)
    Bc = neighbor_xyz - c[..., None, :]
    S = torch.einsum('...ki,...kj->...ij', Bc, Bc)
    lam, V = linalg.eigh3_closed(S)
    lam = torch.clamp(lam, min=0.0)
    a = torch.einsum('...ij,...i->...j', V, c)                # v_i . c
    s_dir = lam + K * (a * a)
    eps_rank = 100.0 * torch.finfo(dtype).eps
    active = s_dir > eps_rank * torch.amax(s_dir, dim=-1, keepdim=True)
    mu = torch.amin(torch.where(active, lam, float("inf")), dim=-1)
    mu = torch.where(torch.isfinite(mu), mu, 0.0)
    lam_ok = lam > 1e-30
    r = torch.where(lam_ok, mu[..., None] / torch.where(lam_ok, lam, 1.0),
                    1.0)
    r = torch.where(active, r, 0.0)
    num = -torch.einsum('...j,...ij->...i', a * r, V)
    den = mu / K + torch.sum(a * a * r, dim=-1)
    ok_den = torch.abs(den) > 1e-30
    x = num / torch.where(ok_den, den, 1.0)[..., None]
    ps_sq = torch.sum(x * x, dim=-1)
    ok = ok_den & (ps_sq >= 1e-12)
    ps = torch.sqrt(torch.where(ok, ps_sq, 1.0))
    return x / ps[..., None], 1.0 / ps, ok


def find_correspondences(source_xyz, R, t, target_xyz, target_valid=None,
                         source_valid=None,
                         params: CorrespondenceParams = CorrespondenceParams(),
                         chunk: int = 2048, grid=None) -> Correspondences:
    """The correspondence pass of one iteration.

    ``grid`` selects the search backend: None, the brute-force k-NN
    (``knn.knn``, K2 in f32, refine 2k); a ``voxel_grid.GridIndex`` over
    the target, its exact neighbourhood walk; a ``block_sparse.BlockIndex``
    over the sorted target, the block-culled search (the source must be
    sorted the same way).  Validity must be baked into an index."""
    p_world = source_xyz @ R.T + t
    if grid is not None:
        if target_valid is not None:
            raise ValueError(
                "target_valid is not honored on the grid/BlockIndex path -- "
                "bake validity into the index at build time instead")
        from .block_sparse import BlockIndex, block_knn
        if isinstance(grid, BlockIndex):
            sq_d, idx, _ = block_knn(grid, p_world, params.search_radius,
                                     k=params.k,
                                     num_blocks=params.num_blocks)
        else:
            from .voxel_grid import grid_knn
            sq_d, idx = grid_knn(grid, p_world, k=params.k)
    else:
        sq_d, idx = knn_mod.knn(p_world, target_xyz, target_valid,
                                k=params.k, chunk=chunk, refine=2 * params.k)
    return correspondence_tail(p_world, sq_d, idx, target_xyz[idx], params,
                               source_valid)


def correspondence_tail(p_world, sq_d, idx, neigh,
                        params: CorrespondenceParams,
                        source_valid=None) -> Correspondences:
    """Post-search half of the pass: plane fit, thickness gate, robust
    weight.  Shared by every search backend."""
    in_radius = sq_d[:, params.k - 1] < params.search_radius ** 2
    normal, d_off, fit_ok = fit_planes(neigh)
    plane_dist = torch.einsum('nkj,nj->nk', neigh, normal) + d_off[:, None]
    max_dev_sq = torch.amax(plane_dist * plane_dist, dim=-1)
    plane_ok = max_dev_sq < params.max_plane_thickness ** 2
    residual = torch.einsum('nj,nj->n', p_world, normal) + d_off
    s = torch.clamp(1.0 - params.weight_slope * torch.abs(residual),
                    min=0.0)
    weight_ok = s > params.min_weight
    valid = in_radius & fit_ok & plane_ok & weight_ok
    if source_valid is not None:
        valid = valid & source_valid
        in_radius = in_radius & source_valid
    weight = torch.where(valid, s, 0.0)
    return Correspondences(valid=valid, in_radius=in_radius, normal=normal,
                           residual=residual, weight=weight, nn_idx=idx)
