"""Voxel-grid spatial indexes (counterpart of
``dcreg_tpu/ops/voxel_grid.py``).

``VoxelGrid`` / ``voxel_knn``: the voxel odometry's map index, built on
the device: a voxel id per point (invalid points past every real voxel),
a stable sort by id, and per query the ``capacity`` first slots of each
voxel of its 27-neighbourhood, found by binary search on the sorted ids;
the k smallest of those 27 * capacity candidates are the answer.

``GridIndex`` / ``grid_knn``: the pair engines' CSR index, built once per
target cloud on the host in numpy: points sorted by cell, CSR start
offsets per cell, static grid dims and ``cap``, the exact maximum
occupancy of any 27-cell neighbourhood.  A query walks its
neighbourhood's buckets through the cumulative counts, so it evaluates
at most ``cap`` candidates and never drops one.

With voxel_size >= the search radius the neighbourhood covers the whole
search ball, so gated results equal brute force (for ``voxel_knn`` when
no voxel holds more than ``capacity`` points).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple

import numpy as np
import torch

from ..utils import resolve_device
from .knn_kernels import _exact_sq, _extract_k_smallest

# offsets of the 27-neighbourhood, (27, 3), in the JAX module's order
_NEIGHBORHOOD = np.stack(np.meshgrid(np.arange(-1, 2), np.arange(-1, 2),
                                     np.arange(-1, 2), indexing="ij"),
                         axis=-1).reshape(27, 3)
_OFFSETS = tuple(map(tuple, _NEIGHBORHOOD.tolist()))


@functools.lru_cache(maxsize=None)
def _device_constant(values: tuple, device):
    """An int64 tensor of ``values`` on ``device``, made once: a search
    inside a captured CUDA graph builds no tensor from host data (the
    capture's eager warm-up makes it)."""
    return torch.as_tensor(values, dtype=torch.int64, device=device)


class VoxelGrid(NamedTuple):
    """Voxel index over a fixed point set; ids are int64."""
    points: torch.Tensor           # (M, 3) indexed points, original order
    sorted_idx: torch.Tensor       # (M,) point indices sorted by voxel id
    voxel_of_sorted: torch.Tensor  # (M,) voxel id of each sorted point
    origin: torch.Tensor           # (3,) valid points' min corner - edge/2
    inv_size: torch.Tensor         # () 1 / voxel edge
    dims: torch.Tensor             # (3,) grid dimensions
    valid: torch.Tensor            # (M,) bool


def _voxel_id(coords, dims):
    """Linear id (ix * ny + iy) * nz + iz of coordinates clipped into the
    grid."""
    c = torch.minimum(torch.clamp(coords, min=0), dims - 1)
    return (c[..., 0] * dims[1] + c[..., 1]) * dims[2] + c[..., 2]


def build_voxel_grid(points, voxel_size: float, valid=None,
                     device=None) -> VoxelGrid:
    """Index ``points`` (M, 3) into voxels of edge ``voxel_size`` on
    ``device`` (cuda unless told otherwise); the points keep their
    dtype.  For exact gated k-NN pick voxel_size >= the search radius."""
    dev = resolve_device(device)
    points = torch.as_tensor(points, device=dev)
    M = points.shape[0]
    valid = (torch.ones(M, dtype=torch.bool, device=dev) if valid is None
             else torch.as_tensor(valid, device=dev).bool())
    big = 3.4e38
    lo = torch.amin(torch.where(valid[:, None], points, big), dim=0)
    hi = torch.amax(torch.where(valid[:, None], points, -big), dim=0)
    origin = lo - voxel_size * 0.5
    inv = 1.0 / voxel_size
    dims = torch.clamp(torch.ceil((hi - origin) * inv).long() + 1, min=1)
    coords = torch.floor((points - origin) * inv).long()
    # invalid points go to a sentinel id past every real voxel
    sentinel = dims[0] * dims[1] * dims[2] + 1
    vid = torch.where(valid, _voxel_id(coords, dims), sentinel)
    order = torch.argsort(vid, stable=True)
    return VoxelGrid(points=points, sorted_idx=order,
                     voxel_of_sorted=vid[order], origin=origin,
                     inv_size=torch.tensor(inv, dtype=points.dtype,
                                           device=dev),
                     dims=dims, valid=valid)


def _k_smallest_by_slot(d, cand, k: int):
    """The k smallest distances of each row (..., C), ascending, equal
    distances in slot order (``lax.top_k``'s order), and their ids.  f32
    ranks an exact int64 key (distance bits, slot); f64 sorts stably."""
    if d.dtype == torch.float32:
        slot = torch.arange(d.shape[-1], device=d.device)
        key = (d.view(torch.int32).long() << 32) | slot
        key = torch.topk(key, k, dim=-1, largest=False).values
        sel = key & 0xFFFFFFFF
        vals = (key >> 32).to(torch.int32).view(torch.float32)
    else:
        vals, sel = torch.sort(d, dim=-1, stable=True)
        vals, sel = vals[..., :k], sel[..., :k]
    return vals, torch.gather(cand, -1, sel)


def voxel_knn(grid: VoxelGrid, query, k: int = 5, capacity: int = 32,
              chunk: int = 1024):
    """k nearest neighbours of each query (N, 3) among the first
    ``capacity`` points of each voxel of its 27-neighbourhood, ``chunk``
    queries at a time.  Returns (sq_dists (N, k) ascending, indices
    (N, k) int64 into ``grid.points``); a missing neighbour carries +inf
    and index 0."""
    dev = query.device
    offsets = _device_constant(_OFFSETS, dev)
    slot = torch.arange(capacity, device=dev)
    last = grid.sorted_idx.shape[0] - 1
    d_out, i_out = [], []
    for c0 in range(0, query.shape[0], chunk):
        q = query[c0:c0 + chunk]
        coords = torch.floor((q - grid.origin) * grid.inv_size).long()
        neigh = coords[:, None, :] + offsets                  # (C, 27, 3)
        in_grid = torch.all((neigh >= 0) & (neigh < grid.dims), dim=-1)
        vids = _voxel_id(neigh, grid.dims)                    # (C, 27)
        starts = torch.searchsorted(grid.voxel_of_sorted, vids)
        ends = torch.searchsorted(grid.voxel_of_sorted, vids, right=True)
        counts = torch.where(in_grid, ends - starts, 0)
        cand_ok = slot < torch.clamp(counts, max=capacity)[..., None]
        pos = torch.clamp(starts[..., None] + slot, 0, last)  # (C, 27, cap)
        cand = grid.sorted_idx[pos].reshape(q.shape[0], -1)
        d = _exact_sq(grid.points[cand], q)
        d = torch.where(cand_ok.reshape(d.shape), d, float("inf"))
        d, i = _k_smallest_by_slot(d, cand, k)
        d_out.append(d)
        i_out.append(torch.where(torch.isfinite(d), i, 0))
    return torch.cat(d_out), torch.cat(i_out)


@dataclasses.dataclass(frozen=True)
class GridIndex:
    points: torch.Tensor    # (M, 3) indexed points, original order
    order: torch.Tensor     # (V,) int64 valid-point indices sorted by cell
    start: torch.Tensor     # (ncells + 1,) int64 CSR offsets into order
    origin: torch.Tensor    # (3,) grid min corner
    dims: tuple             # (nx, ny, nz)
    voxel_size: float
    cap: int                # exact max 27-neighbourhood occupancy


def build_grid_index(points, voxel_size: float, valid=None,
                     dtype=torch.float32, device=None) -> GridIndex:
    """Host-side CSR grid build over (M, 3) ``points`` with edge
    ``voxel_size``; invalid points (``valid`` False) are left out.  The
    index lives on ``device`` (cuda unless told otherwise)."""
    dev = resolve_device(device)
    pts = np.asarray(points, np.float64)
    M = pts.shape[0]
    vmask = (np.ones(M, bool) if valid is None
             else np.asarray(valid, bool))
    vp = pts[vmask]
    if vp.shape[0] == 0:
        raise ValueError("grid index needs at least one valid point")
    origin = vp.min(axis=0) - 0.5 * voxel_size
    coords = np.floor((vp - origin) * (1.0 / voxel_size)).astype(np.int64)
    dims = tuple(int(d) for d in coords.max(axis=0) + 1)
    ncells = dims[0] * dims[1] * dims[2]
    if ncells > 200_000_000:
        raise ValueError(f"grid too large ({ncells} cells); increase "
                         f"voxel_size or crop the cloud")
    flat = (coords[:, 0] * dims[1] + coords[:, 1]) * dims[2] + coords[:, 2]
    perm = np.argsort(flat, kind="stable")
    order = np.nonzero(vmask)[0][perm]
    start = np.searchsorted(flat[perm], np.arange(ncells + 1))

    # exact candidate bound: the largest 27-neighbourhood occupancy over
    # every cell of the 1-dilated grid (any query position)
    counts = np.bincount(flat, minlength=ncells).reshape(dims)
    padded = np.pad(counts, 2)
    S = np.zeros(tuple(d + 2 for d in dims), np.int64)
    for dx in (0, 1, 2):
        for dy in (0, 1, 2):
            for dz in (0, 1, 2):
                S += padded[dx:dx + dims[0] + 2, dy:dy + dims[1] + 2,
                            dz:dz + dims[2] + 2]
    cap = max(8, -(-int(S.max()) // 8) * 8)
    return GridIndex(points=torch.as_tensor(pts, dtype=dtype, device=dev),
                     order=torch.as_tensor(order, device=dev),
                     start=torch.as_tensor(start, device=dev),
                     origin=torch.as_tensor(origin, dtype=dtype, device=dev),
                     dims=dims, voxel_size=float(voxel_size), cap=cap)


def grid_knn(grid: GridIndex, query, k: int = 5):
    """Exact k-NN of each query among the grid points of its 27-cell
    neighbourhood.  Returns (sq_dists (N, k) ascending, indices (N, k)
    int64 into ``grid.points``); a missing neighbour carries +inf.  f64
    selects exactly (equal distances: lower candidate slot first); f32
    takes the packed-key extraction, as the JAX module does."""
    dev = query.device
    nx, ny, nz = grid.dims
    dims = _device_constant(tuple(grid.dims), dev)
    qc = torch.floor((query - grid.origin)
                     * (1.0 / grid.voxel_size)).long()
    nb = qc[:, None, :] + _device_constant(_OFFSETS, dev)
    in_grid = torch.all((nb >= 0) & (nb < dims), dim=-1)       # (N, 27)
    nbc = torch.minimum(torch.clamp(nb, min=0), dims - 1)
    flat = (nbc[..., 0] * ny + nbc[..., 1]) * nz + nbc[..., 2]
    s = grid.start[flat]
    cnt = torch.where(in_grid, grid.start[flat + 1] - s, 0)
    cum = torch.cumsum(cnt, dim=1)
    total = cum[:, -1]
    # slot c belongs to bucket b(c) = #{j : cum[j] <= c}
    c = torch.arange(grid.cap, device=dev)
    b = torch.sum(cum[:, :, None] <= c[None, None, :], dim=1)  # (N, cap)
    prev = torch.where(b > 0, torch.gather(cum, 1, torch.clamp(b - 1,
                                                               min=0)), 0)
    pos = torch.gather(s, 1, torch.clamp(b, max=26)) + (c[None, :] - prev)
    valid_slot = c[None, :] < total[:, None]
    pos = torch.clamp(pos, 0, max(grid.order.shape[0] - 1, 0))
    cand = grid.order[pos]                                     # (N, cap)
    diff = grid.points[cand] - query[:, None, :]
    d = torch.sum(diff * diff, dim=-1)
    d = torch.where(valid_slot, d, float("inf"))
    if query.dtype == torch.float64:
        d, sel = torch.sort(d, dim=-1, stable=True)
        return d[:, :k], torch.gather(cand, 1, sel[:, :k])
    return _extract_k_smallest(d, cand, k)
